"""The port's NGram against ``petastorm_tpu.ngram`` (``tests/test_ngram.py``):
the same eight cases, each held to the JAX package's answer on the same
rows: lengths and field names, windows with gaps, no overlap, negative and
sparse offsets, the refused constructions, and ``make_reader(schema_fields=
NGram(...))`` end to end (dummy and thread pools, regex fields, with drop
partitions) window for window equal to the JAX reader's. Exact.
"""

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.ngram import NGram as JaxNGram
from petastorm_tpu_torch import get_schema, make_reader
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.storage import ParquetStore
from tests.conftest import TimeseriesSchema as JaxTimeseriesSchema


def _both(fields, delta, ts, **kwargs):
    return NGram(fields, delta, ts, **kwargs), JaxNGram(fields, delta, ts, **kwargs)


def test_length_and_field_names():
    ours, theirs = _both({0: ['timestamp', 'sensor'], 1: ['sensor'], 2: ['label']}, 5,
                         'timestamp')
    assert ours.length == theirs.length == 3
    assert ours.get_field_names_at_all_timesteps() == \
        theirs.get_field_names_at_all_timesteps() == ['label', 'sensor', 'timestamp']
    assert ours.get_field_names_at_timestep(1) == theirs.get_field_names_at_timestep(1) == \
        ['sensor']
    assert ours.get_field_names_at_timestep(7) == []


def test_form_ngram_basic():
    rows = [{'timestamp': t, 'value': t * 10} for t in [3, 1, 2, 5, 4]]
    ours, theirs = _both({0: ['timestamp', 'value'], 1: ['value']}, 1, 'timestamp')
    windows = ours.form_ngram(rows, None)
    assert windows == theirs.form_ngram(rows, None)
    assert len(windows) == 4
    assert windows[0][0] == {'timestamp': 1, 'value': 10} and windows[0][1] == {'value': 20}


def test_form_ngram_delta_threshold_gap():
    rows = [{'timestamp': t} for t in [1, 2, 3, 10, 11, 12]]
    ours, theirs = _both({0: ['timestamp'], 1: ['timestamp']}, 2, 'timestamp')
    windows = ours.form_ngram(rows, None)
    assert windows == theirs.form_ngram(rows, None)
    assert [w[0]['timestamp'] for w in windows] == [1, 2, 10, 11]


def test_form_ngram_no_overlap():
    rows = [{'timestamp': t} for t in range(6)]
    ours, theirs = _both({0: ['timestamp'], 1: ['timestamp']}, 1, 'timestamp',
                         timestamp_overlap=False)
    windows = ours.form_ngram(rows, None)
    assert windows == theirs.form_ngram(rows, None)
    assert [w[0]['timestamp'] for w in windows] == [0, 2, 4]


def test_negative_and_sparse_offsets():
    rows = [{'timestamp': t, 'v': t} for t in range(5)]
    ours, theirs = _both({-1: ['v'], 1: ['v', 'timestamp']}, None, 'timestamp')
    assert ours.length == 3
    windows = ours.form_ngram(rows, None)
    assert windows == theirs.form_ngram(rows, None)
    assert len(windows) == 3 and windows[0][-1] == {'v': 0}
    assert windows[0][1] == {'v': 2, 'timestamp': 2}


@pytest.mark.parametrize('args', [({}, 1, 'ts'), ({'a': ['x']}, 1, 'ts'),
                                  ({0: 'not_a_list'}, 1, 'ts')])
def test_invalid_constructions(args):
    with pytest.raises(ValueError):
        NGram(*args)
    with pytest.raises(ValueError):
        JaxNGram(*args)


def _windows(factory, url, ngram, **kwargs):
    out = []
    with factory(url, schema_fields=ngram, **kwargs) as reader:
        for window in reader:
            out.append({offset: sample._asdict() for offset, sample in window.items()})
    return out


def _assert_windows_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for offset in b:
            assert sorted(a[offset]) == sorted(b[offset])
            for name, value in b[offset].items():
                np.testing.assert_array_equal(a[offset][name], value)
                assert np.asarray(a[offset][name]).dtype == np.asarray(value).dtype


def _port_fields(url, names):
    schema = get_schema(ParquetStore(url))
    return [schema.fields[n] for n in names]


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_ngram_end_to_end(timeseries_dataset, pool):
    url = timeseries_dataset.url
    names = {0: ['timestamp', 'sensor'], 1: ['timestamp', 'sensor', 'label']}
    ngram = NGram({k: _port_fields(url, v) for k, v in names.items()}, delta_threshold=2,
                  timestamp_field=_port_fields(url, ['timestamp'])[0])
    jax_ngram = JaxNGram({k: [getattr(JaxTimeseriesSchema, n) for n in v]
                          for k, v in names.items()}, delta_threshold=2,
                         timestamp_field=JaxTimeseriesSchema.timestamp)
    kwargs = dict(reader_pool_type=pool, workers_count=2, shuffle_row_groups=False)
    with make_reader(url, schema_fields=ngram, **kwargs) as reader:
        windows = list(reader)
        assert reader.last_chunk_lineage is None    # a window is not a stored row
    # 40 rows in 2 row-groups of 20, a gap at row 25: 19 + 18 windows.
    assert len(windows) == 19 + 18
    for window in windows:
        assert set(window) == {0, 1}
        assert window[1].timestamp - window[0].timestamp <= 2
        assert window[0].sensor.shape == (3,)
        assert hasattr(window[1], 'label') and not hasattr(window[0], 'label')
    got = _windows(make_reader, url, ngram, **kwargs)
    want = _windows(jax_make_reader, url, jax_ngram, **kwargs)
    if pool == 'thread':     # the two row-groups' windows may arrive in either order
        got, want = (sorted(w, key=lambda x: int(x[0]['timestamp'])) for w in (got, want))
    _assert_windows_equal(got, want)


def test_ngram_end_to_end_regex_fields(timeseries_dataset):
    def ngram(cls):
        return cls({0: ['timestamp', 'sens.*'], 1: ['timestamp']}, delta_threshold=2,
                   timestamp_field='timestamp')

    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    got = _windows(make_reader, timeseries_dataset.url, ngram(NGram), **kwargs)
    assert 'sensor' in got[0][0] and 'timestamp' in got[0][1]
    _assert_windows_equal(got, _windows(jax_make_reader, timeseries_dataset.url,
                                        ngram(JaxNGram), **kwargs))


@pytest.mark.parametrize('partitions', [2, 3])
def test_ngram_with_drop_partitions_equals_jax(timeseries_dataset, partitions):
    """The drop slice reaches ``length - 1`` rows into the next partition,
    so the windows across each cut survive, as in the JAX reader."""
    def ngram(cls):
        return cls({0: ['timestamp'], 1: ['sensor']}, delta_threshold=2,
                   timestamp_field='timestamp')

    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False,
                  shuffle_row_drop_partitions=partitions)
    got = _windows(make_reader, timeseries_dataset.url, ngram(NGram), **kwargs)
    _assert_windows_equal(got, _windows(jax_make_reader, timeseries_dataset.url,
                                        ngram(JaxNGram), **kwargs))
    assert len(got) == 19 + 18


def test_non_overlapping_ngram_with_drop_partitions_raises(timeseries_dataset):
    ngram = NGram({0: ['timestamp'], 1: ['timestamp']}, 1, 'timestamp', timestamp_overlap=False)
    with pytest.raises(NotImplementedError, match='non-overlapping'):
        make_reader(timeseries_dataset.url, schema_fields=ngram, shuffle_row_drop_partitions=2)
    from petastorm_tpu_torch import make_tensor_reader
    with pytest.raises(NotImplementedError, match='NGram'):
        make_tensor_reader(timeseries_dataset.url, schema_fields=ngram)
