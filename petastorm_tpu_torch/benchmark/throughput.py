"""Reader throughput: samples a second of a reader configuration
(counterpart of ``petastorm_tpu/benchmark/throughput.py``).

``read_method``: ``'python'`` iterates the reader itself (rows of
``make_reader``, or the rows of a plain store's ``make_batch_reader``
chunks), ``'torch'`` the batches of a :class:`~petastorm_tpu_torch.loader.
TorchLoader` over that reader, on the card unless ``device='cpu'`` (the JAX
package's ``'jax'``), ``'tensor'`` the decoded column chunks of
``make_tensor_reader`` (counted by their rows), and ``'tf'`` the elements of
``tf_utils.make_petastorm_dataset`` over the reader (TensorFlow needed).
A store without a stored schema is read by ``make_batch_reader``, where the
JAX harness's readers refuse it. ``warmup_cycles_count`` samples are
consumed first, then ``measure_cycles_count`` are timed. The process's RSS
and CPU share come from psutil, and are None where it is not installed.
``spawn_new_process=True`` measures in a fresh interpreter (clean memory
numbers; ``petastorm_tpu/benchmark/throughput.py:23-52``), and
``profile_threads=True`` prints the thread pool's workers' profile.
"""

import json
import os
import tempfile
import time
from collections import namedtuple

from petastorm_tpu_torch.errors import PetastormMetadataError

BenchmarkResult = namedtuple('BenchmarkResult',
                             ['time_mean', 'samples_per_second', 'memory_rss_mb', 'cpu_percent'])

READ_METHODS = ('python', 'torch', 'tensor', 'tf')


def _reader_factory(dataset_url, read_method='python'):
    from petastorm_tpu_torch.etl.dataset_metadata import get_schema
    from petastorm_tpu_torch.reader import make_batch_reader, make_reader, make_tensor_reader
    from petastorm_tpu_torch.storage import ParquetStore
    try:
        get_schema(ParquetStore(dataset_url))
    except PetastormMetadataError:
        return make_batch_reader
    return make_tensor_reader if read_method == 'tensor' else make_reader


def reader_throughput(dataset_url, field_regex=None, warmup_cycles_count=200,
                      measure_cycles_count=1000, pool_type='thread', loaders_count=3,
                      read_method='python', shuffling_queue_size=500, min_after_dequeue=400,
                      spawn_new_process=False, reader_extra_args=None, torch_batch_size=32,
                      shape_policies=None, device='cuda', profile_threads=False):
    """Measure a reader configuration; returns a :class:`BenchmarkResult`.
    ``pool_type`` is any ``reader_pool_type``. ``shuffling_queue_size``/
    ``min_after_dequeue`` are the loader's shuffling buffer (``'torch'``)."""
    if read_method not in READ_METHODS:
        raise ValueError('read_method must be one of {}'.format(READ_METHODS))
    args = (dataset_url, field_regex, warmup_cycles_count, measure_cycles_count, pool_type,
            loaders_count, read_method, shuffling_queue_size, min_after_dequeue,
            reader_extra_args, torch_batch_size, shape_policies, device, profile_threads)
    if not spawn_new_process:
        return _measure(*args)
    from petastorm_tpu_torch.workers.exec_in_new_process import exec_in_new_process
    fd, out_path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        process = exec_in_new_process(_measure_into, out_path, *args)
        if process.wait() != 0:
            raise RuntimeError('the measuring process exited with code {}'.format(
                process.returncode))
        with open(out_path) as f:
            return BenchmarkResult(**json.load(f))
    finally:
        os.unlink(out_path)


def _measure_into(out_path, *args):
    with open(out_path, 'w') as f:
        json.dump(_measure(*args)._asdict(), f)


def _measure(dataset_url, field_regex, warmup_cycles_count, measure_cycles_count, pool_type,
             loaders_count, read_method, shuffling_queue_size, min_after_dequeue,
             reader_extra_args, torch_batch_size, shape_policies, device, profile_threads):
    extra = dict(reader_extra_args or {})
    extra.setdefault('num_epochs', None)
    factory = _reader_factory(dataset_url, read_method)
    reader = factory(dataset_url, schema_fields=field_regex, reader_pool_type=pool_type,
                     workers_count=loaders_count, pool_profiling=profile_threads, **extra)
    try:
        import psutil
        process = psutil.Process()
    except ImportError:
        process = None
    loader = None
    try:
        if read_method == 'torch':
            from petastorm_tpu_torch.loader import TorchLoader
            loader = TorchLoader(reader, torch_batch_size, device=device,
                                 shuffling_queue_capacity=shuffling_queue_size,
                                 min_after_dequeue=min_after_dequeue,
                                 shape_policies=shape_policies)
            iterator, unit = iter(loader), torch_batch_size
        elif read_method == 'tf':
            from petastorm_tpu_torch.tf_utils import make_petastorm_dataset
            iterator = iter(make_petastorm_dataset(reader).as_numpy_iterator())
            unit = None if reader.batched_output else 1
        else:
            # A chunk of a batched reader counts its rows.
            iterator, unit = iter(reader), (None if reader.batched_output else 1)

        def consume(target):
            done = 0
            while done < target:
                sample = next(iterator)
                done += len(sample[0]) if unit is None else unit
            return done

        consume(max(1, warmup_cycles_count))
        if process is not None:
            process.cpu_percent()       # opens the CPU window
        start = time.perf_counter()
        samples = consume(max(1, measure_cycles_count))
        elapsed = time.perf_counter() - start
        cpu = process.cpu_percent() if process is not None else None
        rss_mb = process.memory_info().rss / (1024 * 1024) if process is not None else None
        return BenchmarkResult(time_mean=elapsed / samples, samples_per_second=samples / elapsed,
                               memory_rss_mb=rss_mb, cpu_percent=cpu)
    finally:
        if loader is not None:
            loader.close()
        reader.stop()
        reader.join()
