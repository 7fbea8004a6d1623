"""Hello world through the port: a petastorm store and a plain Parquet store,
each read back (counterpart of ``examples/hello_world/generate_dataset.py``,
``read_dataset.py`` and ``external_dataset.py``).

    python -m petastorm_tpu_torch.examples.hello_world [--dataset-url URL] [--device cpu]

``generate_hello_world_dataset`` writes the hello-world schema (a PNG
image, a 4-D ndarray with two variable dimensions, an id) through
``materialize_dataset``; ``read_hello_world`` reads it per row, as
encoded column batches, and as padded card batches through
``TorchLoader``. ``generate_external_dataset`` writes a store with plain
pyarrow (no schema metadata); ``read_external`` reads it through
``make_batch_reader`` and ``make_converter`` turns an in-memory table into
card batches.
"""

import argparse
import os
import tempfile
import warnings

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch import (CompressedImageCodec, NdarrayCodec, PadTo, ScalarCodec,
                                 TorchLoader, Unischema, UnischemaField, make_batch_reader,
                                 make_reader, materialize_dataset)
from petastorm_tpu_torch.converter import make_converter

HelloWorldSchema = Unischema('HelloWorldSchema', [
    UnischemaField('id', np.int32, (), ScalarCodec(np.int32), False),
    UnischemaField('image1', np.uint8, (128, 256, 3), CompressedImageCodec('png'), False),
    UnischemaField('array_4d', np.uint8, (None, 128, 30, None), NdarrayCodec(), False),
])


def generate_hello_world_dataset(output_url, rows_count=100):
    """The hello-world store (the JAX example's rows, seed 0)."""
    rng = np.random.default_rng(0)
    with materialize_dataset(output_url, HelloWorldSchema, row_group_size_mb=32) as writer:
        for i in range(rows_count):
            writer.write({'id': i,
                          'image1': rng.integers(0, 255, (128, 256, 3), dtype=np.uint8),
                          'array_4d': rng.integers(0, 255, (4, 128, 30, 3), dtype=np.uint8)})


def read_hello_world(dataset_url, device='cuda', batch_size=8):
    """``(first row, first encoded batch's rows, first card batch)``."""
    with make_reader(dataset_url) as reader:
        row = next(reader)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')      # a petastorm store: encoded columns, on purpose
        with make_batch_reader(dataset_url) as reader:
            encoded_rows = len(next(reader).id)
    with make_reader(dataset_url, num_epochs=None) as reader:
        with TorchLoader(reader, batch_size, device=device,
                         shape_policies={'array_4d': PadTo((4, 128, 30, 3))}) as loader:
            batch = next(loader)
    return row, encoded_rows, batch


def generate_external_dataset(path, rows=100):
    """A store written by some other system (plain pyarrow, 25-row groups)."""
    rng = np.random.default_rng(0)
    table = pa.table({'id': pa.array(np.arange(rows, dtype=np.int64)),
                      'value1': pa.array(rng.standard_normal(rows)),
                      'value2': pa.array(rng.integers(0, 100, rows, dtype=np.int32))})
    os.makedirs(path, exist_ok=True)
    pq.write_table(table, os.path.join(path, 'data.parquet'), row_group_size=25)


def read_external(dataset_url, device='cuda', batch_size=16):
    """``(rows read by make_batch_reader, a converter's first card batch)``."""
    with make_batch_reader(dataset_url, reader_pool_type='thread', workers_count=2) as reader:
        total = sum(len(batch.id) for batch in reader)
    rng = np.random.default_rng(1)
    table = pa.table({'feature': rng.random(64), 'label': rng.integers(0, 10, 64)})
    converter = make_converter(table)            # float64 narrowed to float32
    try:
        with converter.make_torch_loader(batch_size=batch_size, device=device, num_epochs=1,
                                         shuffle_row_groups=False) as loader:
            batch = next(loader)
    finally:
        converter.delete()
    return total, batch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--dataset-url', default=None,
                        help='where to write the hello-world store (default: a temporary '
                             'directory, removed at the end)')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix='hello_world_') as workdir:
        url = args.dataset_url or 'file://' + os.path.join(workdir, 'hello_world')
        generate_hello_world_dataset(url)
        row, encoded_rows, batch = read_hello_world(url, args.device)
        print('row', row.id, row.image1.shape, row.array_4d.shape)
        print('batch of', encoded_rows, 'encoded rows')
        print('card batch', tuple(batch.image1.shape), batch.image1.dtype, batch.image1.device)
        external = os.path.join(workdir, 'external')
        generate_external_dataset(external)
        total, batch = read_external('file://' + external, args.device)
        print('read {} rows in columnar batches; converter batch {} {}'.format(
            total, tuple(batch.feature.shape), batch.feature.dtype))
    return 0


if __name__ == '__main__':
    main()
