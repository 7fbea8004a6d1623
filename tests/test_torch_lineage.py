"""Batch provenance of the port against the JAX package's
(``tests/test_lineage.py``): the collector's spans and coalescing, a
loader's records segment for segment (path, row-group, row range, drop,
tier) beside ``JaxLoader``'s on the same deterministic stream, replay
through the port's own decoders and dtype rule bit-identical to the
delivered batches (int64 included: the port keeps it), the ledger's torn
tail, bounds and drop accounting, and a shuffling buffer's inexact
records. All comparisons are exact.
"""

import json
import os

import numpy as np
import pytest

from petastorm_tpu import determinism as jax_det
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu.jax_loader import JaxLoader
from petastorm_tpu.lineage import LineageCollector as JaxCollector
from petastorm_tpu.lineage import read_ledger_dir as jax_read_ledger_dir
from petastorm_tpu_torch import (NdarrayCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, lineage, make_reader, make_tensor_reader,
                                 write_dataset)
from petastorm_tpu_torch.lineage import (LineageCollector, LineageTracker, ReplayError,
                                         find_record, read_ledger_dir, read_ledger_file,
                                         replay_record, verify_record)

ROWS, PER_GROUP = 64, 8
SEGMENT_KEYS = ('path', 'row_group', 'piece_index', 'row_start', 'row_stop', 'drop',
                'chunk_rows', 'tier', 'permuted', 'filtered')


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    schema = Unischema('LineageSchema', [
        UnischemaField('id', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False),
    ])
    rng = np.random.default_rng(11)
    url = 'file://' + str(tmp_path_factory.mktemp('lineage') / 'ds')
    write_dataset(url, schema, ({'id': i, 'vec': rng.random(4, dtype=np.float32)}
                                for i in range(ROWS)), rows_per_row_group=PER_GROUP)
    return url


def _run_loader(reader, batch_size, ledger_dir, **kwargs):
    """Drain a port loader with lineage armed: (live host batches, records,
    ctx)."""
    live = []
    with reader:
        with TorchLoader(reader, batch_size, device='cpu', prefetch=2,
                         lineage=str(ledger_dir), **kwargs) as loader:
            for batch in loader:
                live.append({name: getattr(batch, name).numpy().copy() for name in batch._fields})
                assert loader.last_provenance['batch_id'] == len(live) - 1
            assert loader.stats['lineage']['records'] == len(live)
    (_, ctx, records), = read_ledger_dir(str(ledger_dir))
    return live, records, ctx


def _assert_replay_matches(records, ctx, live):
    for record in records:
        replayed = verify_record(record, ctx)
        for name in record['fields']:
            assert replayed[name].dtype == live[record['batch_id']][name].dtype
            assert replayed[name].tobytes() == live[record['batch_id']][name].tobytes(), \
                (record['batch_id'], name)


def _segments(records):
    return [[tuple(s.get(k) for k in SEGMENT_KEYS) for s in r['segments']] for r in records]


# -- the collector -----------------------------------------------------------------

class _Sink(object):
    def __init__(self):
        self.pending = []

    def _push_pending(self, entry):
        self.pending.append(entry)


def _segment(row_group=0, rows=10, start=0):
    return {'path': 'p', 'row_group': row_group, 'drop': None, 'chunk_rows': rows,
            'row_start': start, 'tier': 'decode', 'permuted': False, 'filtered': False}


def _collect(cls, script):
    sink = _Sink()
    collector = cls(sink, digest=True)
    for op, *args in script:
        if op == 'chunk':
            collector.on_chunk(*args)
        elif op == 'batch':
            n, padded = args
            collector.on_batch(n, batch={'x': np.arange(n + padded, dtype=np.int64)},
                               padded=padded)
        else:
            collector.mark_inexact()
    return sink.pending


SCRIPTS = {
    'fifo': [('chunk', _segment(0, 10), 10), ('chunk', _segment(1, 10), 10), ('batch', 6, 0),
             ('batch', 6, 0), ('batch', 8, 0)],
    'coalesce': [('chunk', dict(_segment(rows=8), row_start=i), 1) for i in range(8)]
    + [('batch', 8, 0)],
    'gap': [('chunk', dict(_segment(rows=8), row_start=i), 1) for i in (0, 1, 3, 4)]
    + [('batch', 4, 0)],
    'unknown': [('chunk', None, 4), ('batch', 4, 0)],
    'pad': [('chunk', _segment(2, 5), 5), ('batch', 5, 3)],
    'inexact': [('chunk', _segment(0, 4), 4), ('inexact',), ('batch', 4, 0)],
    'resume_skip': [('chunk', _segment(0, 10, start=3), 7), ('batch', 4, 0), ('batch', 3, 0)],
}


@pytest.mark.parametrize('script', sorted(SCRIPTS))
def test_collector_entries_equal_jax(script):
    got = _collect(LineageCollector, SCRIPTS[script])
    assert got == _collect(JaxCollector, SCRIPTS[script])
    if script == 'coalesce':
        assert [(s['row_start'], s['row_stop']) for s in got[0]['segments']] == [(0, 8)]


# -- records and replay through the loader ----------------------------------------------

@pytest.mark.parametrize('kind', ['tensor', 'row'])
def test_loader_segments_equal_jax_batch_by_batch(store, kind, tmp_path):
    """Deterministic readers feed both loaders the same stream, so the
    records name the same spans of the same row-groups, batch by batch."""
    port, jax = ((make_tensor_reader, jax_make_tensor_reader) if kind == 'tensor'
                 else (make_reader, jax_make_reader))
    kwargs = dict(deterministic=True, seed=5, num_epochs=2, workers_count=3)
    live, records, ctx = _run_loader(port(store, **kwargs), 12, tmp_path / 'port',
                                     last_batch='partial')
    with jax(store, **kwargs) as reader:
        with JaxLoader(reader, 12, prefetch=2, lineage=str(tmp_path / 'jax'),
                       last_batch='partial') as loader:
            for _ in loader:
                pass
    (_, jax_ctx, jax_records), = jax_read_ledger_dir(str(tmp_path / 'jax'))
    assert _segments(records) == _segments(jax_records)
    assert [r['rows'] for r in records] == [r['rows'] for r in jax_records]
    assert [r['exact'] for r in records] == [r['exact'] for r in jax_records]
    # The shuffle state is sampled at delivery (advisory at an epoch's
    # boundary, where prefetch runs ahead), so each record's (epoch, order
    # digest) is held to the deterministic order of that epoch.
    items = [{'piece_index': i, 'shuffle_row_drop_partition': (0, 1)}
             for i in range(ROWS // PER_GROUP)]
    for r in records + jax_records:
        epoch = r['shuffle']['epoch']
        assert r['shuffle']['order_digest'] == jax_det.order_digest(
            items, jax_det.epoch_order(len(items), 5, epoch))
    for key in ('mode', 'url', 'dataset_path_hash', 'fields', 'schema_hash', 'seed',
                'deterministic', 'n_row_groups', 'batch_size', 'last_batch'):
        assert ctx[key] == jax_ctx[key], key
    # The JAX loader narrows int64 to int32; vec is float32 in both.
    assert [r['digest']['vec'] for r in records] == [r['digest']['vec'] for r in jax_records]
    _assert_replay_matches(records, ctx, live)


def test_tensor_records_structure(store, tmp_path):
    reader = make_tensor_reader(store, workers_count=2, shuffle_row_groups=True, seed=7)
    live, records, ctx = _run_loader(reader, 16, tmp_path / 'ledger')
    assert [r['batch_id'] for r in records] == list(range(len(live)))
    assert (ctx['mode'], ctx['url'], ctx['seed']) == ('tensor', store, 7)
    for record in records:
        assert record['rows'] == 16 and record['exact'] is True
        assert sum(s['row_stop'] - s['row_start'] for s in record['segments']) == 16
        assert {s['tier'] for s in record['segments']} == {'decode'}
        assert all(s['worker_pid'] == os.getpid() for s in record['segments'])
        assert set(record['digest']) == set(record['fields']) == {'id', 'vec'}
        assert record['shuffle']['epoch'] >= 1 and record['shuffle']['order_digest']


def test_replay_bit_identical_thread_pool(store, tmp_path):
    reader = make_tensor_reader(store, workers_count=3, shuffle_row_groups=True, seed=13,
                                num_epochs=2)
    live, records, ctx = _run_loader(reader, 16, tmp_path / 'ledger')
    assert len(records) == len(live) == 2 * ROWS // 16
    assert all(live[0]['id'].dtype == np.int64 for _ in (0,))
    _assert_replay_matches(records, ctx, live)


@pytest.mark.parametrize('last_batch', ['pad', 'partial'])
def test_replay_pad_and_partial_batches(store, tmp_path, last_batch):
    reader = make_tensor_reader(store, workers_count=2, shuffle_row_groups=False)
    live, records, ctx = _run_loader(reader, 24, tmp_path / 'ledger', last_batch=last_batch)
    tail = ROWS % 24
    assert records[-1]['padded'] == (24 - tail if last_batch == 'pad' else 0)
    assert records[-1]['rows'] == (24 if last_batch == 'pad' else tail)
    _assert_replay_matches(records, ctx, live)


@pytest.mark.parametrize('last_batch', ['drop', 'pad'])
def test_per_row_reader_replay(store, tmp_path, last_batch):
    reader = make_reader(store, workers_count=2, shuffle_row_groups=True, seed=3)
    live, records, ctx = _run_loader(reader, 10, tmp_path / 'ledger', last_batch=last_batch)
    assert ctx['mode'] == 'py_dict'
    assert all(len(r['segments']) <= 3 for r in records)   # contiguous rows coalesce
    assert live[0]['id'].dtype == np.int64
    _assert_replay_matches(records, ctx, live)


def test_memory_cache_tier_recorded(store, tmp_path):
    reader = make_tensor_reader(store, workers_count=1, shuffle_row_groups=False, num_epochs=2,
                                cache_type='memory')
    live, records, ctx = _run_loader(reader, ROWS, tmp_path / 'ledger')
    tiers = [{s['tier'] for s in r['segments']} for r in records]
    assert tiers[0] == {'decode'} and tiers[-1] == {'memory'}
    _assert_replay_matches(records, ctx, live)


def test_resumed_reader_records_start_past_the_skip(store, tmp_path):
    """A resume mid-row-group: the first record's span starts past the rows
    the earlier session consumed, and replays."""
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    with make_tensor_reader(store, **kwargs) as reader:
        with TorchLoader(reader, 5, device='cpu', prefetch=0) as loader:
            next(loader)
            state = loader.state_dict()
    live, records, ctx = _run_loader(make_tensor_reader(store, resume_state=state, **kwargs), 5,
                                     tmp_path / 'ledger')
    assert (records[0]['segments'][0]['row_start'], live[0]['id'][0]) == (5, 5)
    _assert_replay_matches(records, ctx, live)


def test_shuffling_buffer_marks_records_inexact(store, tmp_path):
    reader = make_reader(store, workers_count=2, shuffle_row_groups=False)
    live, records, ctx = _run_loader(reader, 8, tmp_path / 'ledger',
                                     shuffling_queue_capacity=32, seed=1)
    assert records and all(r['exact'] is False for r in records)
    with pytest.raises(ReplayError, match='not exact'):
        replay_record(records[0], ctx)


def test_shape_policies_refuse_replay(store, tmp_path):
    from petastorm_tpu_torch import PadTo
    reader = make_reader(store, workers_count=1, shuffle_row_groups=False)
    _, records, ctx = _run_loader(reader, 8, tmp_path / 'ledger',
                                  shape_policies={'vec': PadTo((4,))})
    with pytest.raises(ReplayError, match='shape policies'):
        replay_record(records[0], ctx)


def test_tampered_digest_raises_mismatch(store, tmp_path):
    reader = make_tensor_reader(store, workers_count=1, shuffle_row_groups=False)
    _, records, ctx = _run_loader(reader, 16, tmp_path / 'ledger')
    record = json.loads(json.dumps(records[1]))
    record['digest']['vec'] ^= 1
    with pytest.raises(lineage.ReplayMismatchError, match='vec'):
        verify_record(record, ctx)


# -- the ledger ------------------------------------------------------------------------

def test_ledger_torn_tail_line_tolerated(store, tmp_path):
    ledger_dir = tmp_path / 'ledger'
    reader = make_tensor_reader(store, workers_count=2, shuffle_row_groups=True, seed=2)
    live, records, ctx = _run_loader(reader, 16, ledger_dir)
    (path,) = [os.path.join(ledger_dir, f) for f in os.listdir(ledger_dir)]
    with open(path, 'a') as f:
        f.write('{"v": 1, "batch_id": 999, "truncated-mid-wr')
    with open(path) as f:
        lines = f.read().splitlines()
    lines.insert(2, 'garbage not json at all')
    with open(path, 'w') as f:
        f.write('\n'.join(lines))
    ctx2, records2 = read_ledger_file(path)
    assert ctx2 == ctx and [r['batch_id'] for r in records2] == [r['batch_id'] for r in records]
    _assert_replay_matches(records2, ctx2, live)
    assert find_record(str(ledger_dir), 2)[1]['batch_id'] == 2
    with pytest.raises(LookupError, match='not found'):
        find_record(str(ledger_dir), 999)


def _deliver(tracker, n, start=0):
    for i in range(start, start + n):
        tracker.collector.on_chunk(_segment(row_group=i, rows=4), 4)
        tracker.collector.on_batch(4)
        assert tracker.deliver() is not None


def test_ledger_bounds_and_drop_accounting(tmp_path):
    tracker = LineageTracker({'mode': 'tensor'}, ledger_dir=str(tmp_path / 'ledger'),
                             max_records=3, ring_size=8, digest=False)
    _deliver(tracker, 6)
    assert tracker.flush()
    tracker.close()
    assert (tracker.records, tracker.dropped, len(tracker.ring())) == (6, 3, 6)
    _, records = read_ledger_file(tracker.ledger_path)
    assert len(records) == 3 and tracker.stats()['dropped'] == 3


def test_closed_ledger_refuses_appends_as_drops(tmp_path):
    tracker = LineageTracker({'mode': 'tensor'}, ledger_dir=str(tmp_path / 'ledger'),
                             digest=False)
    _deliver(tracker, 1)
    tracker.close()
    _deliver(tracker, 1, start=1)
    assert tracker.dropped == 1
    assert [r['batch_id'] for r in read_ledger_file(tracker.ledger_path)[1]] == [0]


def test_tracker_without_ledger_keeps_the_ring_only():
    tracker = LineageTracker({'mode': 'tensor'}, ledger_dir=None, ring_size=2, digest=False)
    _deliver(tracker, 4)
    assert tracker.ledger_path is None and [r['batch_id'] for r in tracker.ring()] == [2, 3]
    assert any(ring['ctx'] == {'mode': 'tensor'} for ring in lineage.live_rings())
    tracker.close()
    assert not any(ring['ctx'] == {'mode': 'tensor'} and ring['records'] == tracker.ring()
                   for ring in lineage.live_rings())


def test_adopted_tracker_survives_loader_close(store, tmp_path):
    tracker = LineageTracker({'mode': 'tensor'}, ledger_dir=str(tmp_path / 'ledger'),
                             digest=False)
    ids = []
    try:
        for _ in range(2):
            with make_tensor_reader(store, workers_count=1) as reader:
                with TorchLoader(reader, 16, device='cpu', lineage=tracker) as loader:
                    for _ in loader:
                        pass
                    ids.append(loader.last_provenance['batch_id'])
        assert tracker.flush()
    finally:
        tracker.close()
    assert [r['batch_id'] for r in read_ledger_file(tracker.ledger_path)[1]] == \
        list(range(ids[-1] + 1))
    assert ids[0] < ids[1] and tracker.dropped == 0


def test_environment_arms_the_ledger(store, tmp_path, monkeypatch):
    monkeypatch.setenv(lineage.ENV_VAR, str(tmp_path / 'env'))
    with make_tensor_reader(store, workers_count=1) as reader:
        with TorchLoader(reader, 16, device='cpu') as loader:
            assert sum(1 for _ in loader) == ROWS // 16
            assert loader.lineage_tracker is not None
    assert len(read_ledger_dir(str(tmp_path / 'env'))[0][2]) == ROWS // 16
    with make_tensor_reader(store, workers_count=1) as reader:
        with TorchLoader(reader, 16, device='cpu', lineage=False) as loader:
            assert loader.lineage_tracker is None and loader.last_provenance is None
