"""The port's test utilities against the JAX package's: ``generate_datapoint``,
``ReaderMock`` and ``compute_correlation_distribution`` on the same seeds."""

import numpy as np
import pytest

from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu import unischema as jax_unischema
from petastorm_tpu.generator import generate_datapoint as jax_generate_datapoint
from petastorm_tpu.test_util.reader_mock import ReaderMock as JaxReaderMock
from petastorm_tpu.test_util.shuffling_analysis import \
    compute_correlation_distribution as jax_correlation
from petastorm_tpu_torch import codecs, unischema
from petastorm_tpu_torch.generator import generate_datapoint
from petastorm_tpu_torch.test_util import ReaderMock
from petastorm_tpu_torch.test_util.shuffling_analysis import compute_correlation_distribution

_FIELDS = [
    ('id', np.int64, (), 'scalar'),
    ('small', np.uint8, (), 'scalar'),
    ('flag', np.bool_, (), 'scalar'),
    ('score', np.float32, (), 'scalar'),
    ('name', np.str_, (), 'scalar'),
    ('matrix', np.float64, (3, 4), 'ndarray'),
    ('mask', np.bool_, (5,), 'ndarray'),
    ('varlen', np.int32, (None,), 'ndarray'),
    ('grid', np.int16, (None, 2), 'ndarray'),
    ('when', np.dtype('datetime64[ns]'), (), 'scalar'),
]


def _schemas():
    def build(unischema_mod, codecs_mod):
        fields = []
        for name, dtype, shape, kind in _FIELDS:
            codec = (codecs_mod.ScalarCodec(dtype) if kind == 'scalar'
                     else codecs_mod.NdarrayCodec())
            fields.append(unischema_mod.UnischemaField(name, dtype, shape, codec, False))
        return unischema_mod.Unischema('GenSchema', fields)
    return build(unischema, codecs), build(jax_unischema, jax_codecs)


def _same_row(a, b):
    assert list(a) == list(b)
    for name in a:
        x, y = a[name], b[name]
        assert type(x) is type(y), name
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, name


@pytest.mark.parametrize('seed', [0, 1, 42])
def test_generate_datapoint_equals_jax(seed):
    port_schema, jax_schema = _schemas()
    port_rng, jax_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(5):
        _same_row(generate_datapoint(port_schema, port_rng),
                  jax_generate_datapoint(jax_schema, jax_rng))


def test_generate_datapoint_refuses_an_unknown_kind():
    schema = unischema.Unischema('Bad', [
        unischema.UnischemaField('c', np.complex64, (), codecs.ScalarCodec(np.complex64), False)])
    with pytest.raises(ValueError, match='Cannot generate data'):
        generate_datapoint(schema, np.random.default_rng(0))


@pytest.mark.parametrize('seed', [0, 7])
def test_reader_mock_equals_jax(seed):
    port_schema, jax_schema = _schemas()
    port, jax = ReaderMock(port_schema, seed=seed), JaxReaderMock(jax_schema, seed=seed)
    with port as reader:
        assert not reader.batched_output and reader.ngram is None
        assert reader.transformed_schema is port_schema and reader.diagnostics == {}
        for _ in range(6):
            a, b = next(reader), next(jax)
            assert type(a).__name__ == type(b).__name__
            _same_row(a._asdict(), b._asdict())
    reader.stop()
    reader.join()


def test_reader_mock_takes_a_generator():
    port_schema, _ = _schemas()
    calls = []

    def fixed(schema, rng):
        calls.append(rng)
        return generate_datapoint(schema, np.random.default_rng(5))

    rows = [ReaderMock(port_schema, schema_data_generator=fixed).next() for _ in range(2)]
    _same_row(rows[0]._asdict(), rows[1]._asdict())
    assert len(calls) == 2


@pytest.mark.parametrize('seed, streams, n', [(0, 4, 100), (3, 1, 2), (9, 6, 37)])
def test_correlation_distribution_equals_jax(seed, streams, n):
    rng = np.random.default_rng(seed)
    ordered = np.arange(n)
    shuffled = [rng.permutation(n)[:n - i] for i in range(streams)]
    port_mean, port_each = compute_correlation_distribution(ordered, shuffled)
    jax_mean, jax_each = jax_correlation(ordered, shuffled)
    assert abs(port_mean - jax_mean) <= 1e-12
    assert len(port_each) == len(jax_each)
    assert all(abs(a - b) <= 1e-12 for a, b in zip(port_each, jax_each))


def test_correlation_of_an_ordered_stream_is_one_and_short_streams_are_skipped():
    mean, each = compute_correlation_distribution(range(10), [list(range(10)), [3]])
    assert len(each) == 1 and abs(each[0] - 1.0) <= 1e-12 and mean == each[0]
    assert compute_correlation_distribution(range(3), []) == (0.0, [])
