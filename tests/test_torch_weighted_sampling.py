"""``WeightedSamplingReader``: the port against the JAX package
(``petastorm_tpu/weighted_sampling_reader.py:22-183``).

The same seed draws the same sources and yields the same chunks and rows;
the checks of mixed readers raise alike; a mixture's ``state_dict()``
(taken from the reader or from a ``TorchLoader`` over it) resumes the same
draw sequence in either package; provenance tags each segment with its
source. Exact throughout.
"""

import json

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.lineage import _digest_array
from petastorm_tpu.weighted_sampling_reader import \
    WeightedSamplingReader as JaxWeightedSamplingReader
from petastorm_tpu_torch import TorchLoader, make_batch_reader, make_reader
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.weighted_sampling_reader import STATE_VERSION, WeightedSamplingReader

PER_GROUP = 8


def _plain(path, rows, offset):
    path.mkdir()
    ids = np.arange(offset, offset + rows)
    table = pa.table({'id': ids, 'tokens': pa.array([[int(i)] * 5 for i in ids],
                                                    pa.list_(pa.int32()))})
    pq.write_table(table, str(path / 'data.parquet'), row_group_size=PER_GROUP)
    return 'file://' + str(path)


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp('mixture')
    return _plain(root / 'a', 48, 0), _plain(root / 'b', 32, 1000)


KWARGS = dict(reader_pool_type='dummy', seed=3, num_epochs=None, shuffle_row_groups=True)


def _mixture(cls, factory, stores, seed=0, resume_state=None, **kwargs):
    kwargs = dict(KWARGS, **kwargs)
    sources = (resume_state or {}).get('sources') or [None, None]
    return cls([factory(url, resume_state=state, **kwargs)
                for url, state in zip(stores, sources)], [0.7, 0.3], seed=seed,
               resume_state=resume_state)


def _draws(mixture, n):
    out = []
    for _ in range(n):
        chunk = next(mixture)
        out.append((mixture.last_chunk_lineage['source'], [int(i) for i in chunk.id]))
    return out


@pytest.mark.parametrize('seed', [0, 1, 12345])
def test_batched_draws_equal_jax(stores, seed):
    with _mixture(WeightedSamplingReader, make_batch_reader, stores, seed) as port:
        got = _draws(port, 30)
    with _mixture(JaxWeightedSamplingReader, jax_make_batch_reader, stores, seed) as jax:
        want = _draws(jax, 30)
    assert got == want
    reckoned = np.searchsorted(np.cumsum([0.7, 0.3]), np.random.default_rng(seed).random(30),
                               side='right')
    assert [s for s, _ in got] == list(reckoned)


def test_per_row_draws_equal_jax(synthetic_dataset, partitioned_synthetic_dataset):
    urls = (synthetic_dataset.url, partitioned_synthetic_dataset.url)
    kwargs = dict(schema_fields=['id', 'matrix'], reader_pool_type='dummy', seed=1,
                  num_epochs=None)
    port = WeightedSamplingReader([make_reader(u, **kwargs) for u in urls], [1, 3], seed=9)
    jax = JaxWeightedSamplingReader([jax_make_reader(u, **kwargs) for u in urls], [1, 3], seed=9)
    with port, jax:
        for _ in range(40):
            a, b = next(port), next(jax)
            assert a.id == b.id and np.array_equal(a.matrix, b.matrix)
            assert port.last_chunk_lineage['source'] == jax.last_chunk_lineage['source']
    assert not port.batched_output and port.transformed_schema is port._readers[0].\
        transformed_schema


def test_the_mixture_ends_with_its_drawn_source(stores):
    port = _mixture(WeightedSamplingReader, make_batch_reader, stores, num_epochs=1)
    jax = _mixture(JaxWeightedSamplingReader, jax_make_batch_reader, stores, num_epochs=1)
    with port, jax:
        got, want = [], []
        for mixture, out in ((port, got), (jax, want)):
            with pytest.raises(StopIteration):
                while True:
                    out.append(_digest_array(next(mixture).id))
            assert mixture.last_row_consumed
    assert got == want


@pytest.mark.filterwarnings('ignore:Dataset at')
def test_mixed_readers_are_checked_as_in_jax(stores, synthetic_dataset):
    a, b = stores
    cases = [
        ('same output schema', lambda f, g: [f(a), f(b, schema_fields=['id'])]),
        ('batched and per-row', lambda f, g: [f(synthetic_dataset.url, schema_fields=['id']),
                                              g(synthetic_dataset.url, schema_fields=['id'])]),
    ]
    for match, build in cases:
        for cls, factory, row_factory in (
                (WeightedSamplingReader, make_batch_reader, make_reader),
                (JaxWeightedSamplingReader, jax_make_batch_reader, jax_make_reader)):
            readers = build(factory, row_factory)
            try:
                with pytest.raises(ValueError, match=match):
                    cls(readers, [1, 1])
            finally:
                for reader in readers:
                    reader.stop()
                    reader.join()
    ngram = NGram({0: ['id'], 1: ['id']}, 5, 'id')
    readers = [make_reader(synthetic_dataset.url, schema_fields=ngram),
               make_reader(synthetic_dataset.url, schema_fields=['id'])]
    with pytest.raises(ValueError, match='ngram'):
        WeightedSamplingReader(readers, [1, 1])
    for reader in readers:
        reader.stop()
        reader.join()
    for cls in (WeightedSamplingReader, JaxWeightedSamplingReader):
        with pytest.raises(ValueError, match='equal length'):
            cls([object()], [1, 2])
        with pytest.raises(ValueError, match='at least one'):
            cls([], [])
        with pytest.raises(ValueError, match='positive'):
            cls([object()], [0])


@pytest.mark.parametrize('direction', ['port_to_jax', 'jax_to_port', 'port_to_port'])
def test_state_round_trip(stores, direction):
    first, second = {'port_to_jax': ('port', 'jax'), 'jax_to_port': ('jax', 'port'),
                     'port_to_port': ('port', 'port')}[direction]
    build = {'port': (WeightedSamplingReader, make_batch_reader),
             'jax': (JaxWeightedSamplingReader, jax_make_batch_reader)}
    kwargs = dict(deterministic=True, reader_pool_type='thread', workers_count=2)
    with _mixture(*build[first], stores, seed=4, **kwargs) as mixture:
        _draws(mixture, 7)
        state = json.loads(json.dumps(mixture.state_dict()))
    assert state['version'] == STATE_VERSION and state['mode'] == 'mixture'
    with _mixture(*build[second], stores, seed=4, resume_state=state, **kwargs) as resumed:
        tail = _draws(resumed, 12)
    with _mixture(*build['port'], stores, seed=4, **kwargs) as whole:
        assert _draws(whole, 19)[7:] == tail


def test_state_from_a_torch_loader_resumes_the_draws(stores):
    kwargs = dict(deterministic=True)
    with _mixture(WeightedSamplingReader, make_batch_reader, stores, seed=2, **kwargs) as mixture:
        with TorchLoader(mixture, PER_GROUP, device='cpu', prefetch=0) as loader:
            for _ in range(5):
                next(loader)
            state = json.loads(json.dumps(loader.state_dict()))
    with _mixture(JaxWeightedSamplingReader, jax_make_batch_reader, stores, seed=2,
                  resume_state=state, **kwargs) as resumed:
        tail = _draws(resumed, 6)
    with _mixture(WeightedSamplingReader, make_batch_reader, stores, seed=2, **kwargs) as whole:
        assert _draws(whole, 11)[5:] == tail
    with pytest.raises(ValueError, match='not a WeightedSamplingReader state'):
        WeightedSamplingReader([object()], [1], resume_state={'mode': 'deterministic'})
    with pytest.raises(ValueError, match='captured 2 sources'):
        WeightedSamplingReader([object()], [1], resume_state=dict(state, sources=None))


def test_provenance_context_equals_jax(stores):
    with _mixture(WeightedSamplingReader, make_batch_reader, stores, seed=5) as port, \
            _mixture(JaxWeightedSamplingReader, jax_make_batch_reader, stores, seed=5) as jax:
        assert port.lineage_context() == jax.lineage_context()
        next(port)
        next(jax)
        segment, want = port.last_chunk_lineage, jax.last_chunk_lineage
        for key in ('source', 'path', 'row_group', 'piece_index', 'chunk_rows', 'row_start',
                    'tier', 'permuted', 'filtered'):
            assert segment[key] == want[key]
        assert port.lineage_state()['sources'][0].keys() == jax.lineage_state()['sources'][0].keys()
