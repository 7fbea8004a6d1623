"""Deterministic mode and the reader's resume against the JAX package.

The permutation (``feistel_permute``, ``epoch_order``, ``shard_positions``)
is Python-int arithmetic: the same integers, exactly. The resequencer, the
stream cursor and ``merge_cursors`` give the same releases and state dicts
for the same events. The readers' deterministic streams are equal chunk by
chunk (sample ids and CRC32 digests of every field), and through the two
loaders batch by batch, the port's int64 cast to int32 for the comparison
(the JAX loader narrows int64; the port keeps it). ``state_dict()`` is
JSON-equal to the JAX reader's; a cursor either package wrote resumes the
other to the uninterrupted stream's remainder. All comparisons are exact.
"""

import json

import numpy as np
import pytest

from petastorm_tpu import determinism as jax_det
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu.jax_loader import JaxLoader
from petastorm_tpu.lineage import _digest_array
from petastorm_tpu.workers import EmptyResultError as JaxEmptyResultError
from petastorm_tpu_torch import (NdarrayCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, determinism, make_reader, make_tensor_reader,
                                 write_dataset)
from petastorm_tpu_torch.reader import Reader
from petastorm_tpu_torch.storage import ParquetStore
from petastorm_tpu_torch.tensor_worker import TensorWorker
from petastorm_tpu_torch.workers import EmptyResultError

ROWS, PER_GROUP, BATCH = 60, 6, 8


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """NdarrayCodec and ScalarCodec fields only: both packages decode them
    to the same bytes."""
    schema = Unischema('DetSchema', [
        UnischemaField('sample_id', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False),
        UnischemaField('code', np.int32, (), ScalarCodec(np.int32), False),
    ])
    rng = np.random.default_rng(11)
    url = 'file://' + str(tmp_path_factory.mktemp('det') / 'store')
    write_dataset(url, schema, ({'sample_id': i, 'vec': rng.random(4, dtype=np.float32),
                                 'code': int(rng.integers(0, 1000))} for i in range(ROWS)),
                  rows_per_row_group=PER_GROUP)
    return url


# -- the permutation -------------------------------------------------------------------

@pytest.mark.parametrize('n', [1, 2, 3, 10, 17, 257])
@pytest.mark.parametrize('seed', [0, 7, None])
def test_epoch_order_equals_jax(n, seed):
    for epoch in (1, 2, 9):
        order = determinism.epoch_order(n, seed, epoch)
        assert order == jax_det.epoch_order(n, seed, epoch)
        assert sorted(order) == list(range(n))
        assert determinism.epoch_key(seed, epoch) == jax_det.epoch_key(seed, epoch)
    assert determinism.epoch_order(n, seed, 1, shuffle=False) == list(range(n))
    key = determinism.epoch_key(seed, 3)
    assert ([determinism.feistel_permute(i, n, key) for i in range(n)]
            == [jax_det.feistel_permute(i, n, key) for i in range(n)])


@pytest.mark.parametrize('shards', [1, 2, 3, 5])
def test_shard_positions_equal_jax(shards):
    for n in (7, 12, 30):
        for base in (0, 1, 5):
            for phase in range(shards):
                for cur in range(shards):
                    assert (determinism.shard_positions(n, base, cur, shards, phase)
                            == jax_det.shard_positions(n, base, cur, shards, phase))
    items = [{'piece_index': i, 'shuffle_row_drop_partition': (0, 1)} for i in range(9)]
    order = determinism.epoch_order(9, 4, 2)
    assert determinism.order_digest(items, order) == jax_det.order_digest(items, order)


def test_feistel_rejects_out_of_range_like_jax():
    for module in (determinism, jax_det):
        with pytest.raises(ValueError, match='out of'):
            module.feistel_permute(5, 5, 1)


# -- resequencer, cursor, merge ------------------------------------------------------

class _FakePool(object):
    def __init__(self, chunks, empty_error):
        self.chunks = list(chunks)
        self.empty_error = empty_error

    def get_results(self):
        if not self.chunks:
            raise self.empty_error()
        return self.chunks.pop(0)


def _tag(seq):
    return {'det': {'seq': seq, 'epoch': 1, 'pos': seq}, 'seq': seq}


@pytest.mark.parametrize('arrivals', [[2, 0, 3, 1], [0, 1, 2, 3], [3, 2, 1, 0],
                                      [1, 2, 0, 4, 3], [5, 4, 3, 2, 1, 0]])
def test_resequencer_releases_equal_jax(arrivals):
    def run(cls, empty_error):
        reseq = cls(end_grace_s=0.01)
        pool = _FakePool([_tag(s) for s in arrivals] + [{'plain': 1}], empty_error)
        out = [reseq.next_chunk(pool) for _ in range(len(arrivals) + 1)]
        stats = reseq.stats()
        return [c.get('seq', 'plain') for c in out], stats['expected_seq'], \
            stats['out_of_order_total']

    assert run(determinism.Resequencer, EmptyResultError) == \
        run(jax_det.Resequencer, JaxEmptyResultError)


def test_resequencer_lost_seq_raises_like_jax():
    for cls, empty in ((determinism.Resequencer, EmptyResultError),
                       (jax_det.Resequencer, JaxEmptyResultError)):
        with pytest.raises(RuntimeError, match='missing ventilation seq 0'):
            _drain(cls(end_grace_s=0.01), _FakePool([_tag(1)], empty))
        reseq = cls()
        reseq.next_chunk(_FakePool([_tag(0)], empty))
        reseq.reset()
        assert reseq.stats()['expected_seq'] == 0


def _drain(reseq, pool):
    while True:
        reseq.next_chunk(pool)


def _cursor_events(module, resume_state=None):
    """One scripted run of a cursor: chunks of 10 rows at positions 0..4 of
    epoch 2, rows attributed unevenly, with a snapshot after each event."""
    cursor = module.DeterministicCursor(resume_state)
    cursor.normalize(8)
    states = []
    for pos, rows in ((3, [4, 6]), (4, [10]), (5, [3]), (6, [7, 10]), (7, [10])):
        states.append(cursor.on_chunk('k', 10, det={'epoch': 2, 'pos': pos, 'seq': pos}))
        for n in rows:
            cursor.rows_yielded('k', n)
            states.append(cursor.state_dict())
    return states


@pytest.mark.parametrize('resume', [
    None, {'version': 1, 'mode': 'deterministic', 'epoch': 2, 'pos': 3, 'rows_into': 4},
    {'version': 1, 'mode': 'deterministic', 'epoch': 2, 'pos': 5, 'rows_into': 2},
    {'version': 1, 'mode': 'deterministic', 'epoch': 1, 'pos': 8, 'rows_into': 0}])
def test_cursor_states_equal_jax(resume):
    assert _cursor_events(determinism, resume) == _cursor_events(jax_det, resume)


def test_cursor_refusals_and_det_tag_cursor_equal_jax():
    for module in (determinism, jax_det):
        with pytest.raises(ValueError, match='deterministic'):
            module.DeterministicCursor({'version': 1, 'mode': None})
        with pytest.raises(ValueError, match='version'):
            module.DeterministicCursor({'version': 9, 'mode': 'deterministic'})
        with pytest.raises(ValueError, match='tag'):
            module.det_tag_cursor({'seq': 1})
    for det, rows in (({'seq': 3, 'epoch': 2, 'pos': 7}, 0), ({'epoch': 1, 'pos': 0}, 5)):
        assert determinism.det_tag_cursor(det, rows) == jax_det.det_tag_cursor(det, rows)


def _cursor(pos, shard=None, count=None, rows=0, config=None, epoch=1):
    out = {'version': 1, 'mode': 'deterministic', 'epoch': epoch, 'pos': pos, 'rows_into': rows}
    if count is not None:
        out.update(cur_shard=shard, shard_count=count)
    if config is not None:
        out['config'] = config
    return out


@pytest.mark.parametrize('states', [
    [_cursor(8, rows=4, epoch=2), _cursor(6, rows=2, epoch=2)],
    [_cursor(8, rows=4), _cursor(8, rows=4)],
    [_cursor(4, 0, 2), _cursor(5, 1, 2)],
    [_cursor(4, 0, 3, config={'url': 'u'}), _cursor(5, 1, 3, config={'url': 'u'}),
     _cursor(3, 2, 3, rows=1, config={'url': 'u'})],
    [_cursor(4, 0, 2)],
    [_cursor(4, 0, 2), _cursor(5, 1, 3)],
    [_cursor(4, config={'url': 'a'}), _cursor(5, config={'url': 'b'})],
    [{'mode': None}], []])
def test_merge_cursors_equals_jax(states):
    def merge(module):
        try:
            return module.merge_cursors([dict(s) for s in states])
        except ValueError as e:
            return 'ValueError: ' + str(e).split(':')[0][:20]

    assert merge(determinism) == merge(jax_det)


def test_ventilator_fast_forward_and_reset_equal_jax():
    """The deterministic feed from a resume cursor, then ``reset()``: a
    full round from epoch 1 (``tests/test_determinism.py:281-347``)."""
    from petastorm_tpu.workers.ventilator import ConcurrentVentilator as JaxVentilator
    from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator

    items = [{'piece_index': i, 'shuffle_row_drop_partition': (0, 1)} for i in range(8)]
    det = {'seed': 5, 'shuffle': True, 'cur_shard': 1, 'shard_count': 3, 'start_epoch': 2,
           'start_pos': 3}

    def feed(make, pump):
        fed = []
        ventilator = make(lambda **kw: fed.append(kw))
        ventilator.start(**({} if pump == 'jax' else {'threaded': False}))
        rounds = []
        for _ in range(2):
            while not ventilator.completed() and (ventilator.pump() or pump != 'jax'):
                pass
            rounds.append([(f['piece_index'], f['pst_det']) for f in fed])
            state = ventilator.lineage_state()
            del fed[:]
            ventilator.reset()
        return rounds, state

    port = feed(lambda fn: ConcurrentVentilator(fn, items, iterations=2, deterministic=det),
                'port')
    jax = feed(lambda fn: JaxVentilator(fn, items, iterations=2, inline=True,
                                        max_ventilation_queue_size=1000, deterministic=det),
               'jax')
    assert port == jax
    rounds = port[0]
    assert [tag['epoch'] for _, tag in rounds[0]] == [2] * len(rounds[0])
    assert {tag['epoch'] for _, tag in rounds[1]} == {1, 2}


# -- the readers' streams ------------------------------------------------------------

def _chunks(factory, url, **kwargs):
    """Every chunk (tensor reader) or row (row reader): sample ids and the
    CRC32 of each field."""
    out = []
    with factory(url, **kwargs) as reader:
        for sample in reader:
            out.append((np.atleast_1d(sample.sample_id).tolist(),
                        {name: _digest_array(np.asarray(getattr(sample, name)))
                         for name in sample._fields}))
    return out


POOLS = [('thread', 1), ('thread', 3), ('dummy', 1)]


@pytest.mark.parametrize('pool,workers', POOLS)
@pytest.mark.parametrize('kind', ['tensor', 'row'])
def test_deterministic_stream_equals_jax(store, kind, pool, workers):
    port, jax = ((make_tensor_reader, jax_make_tensor_reader) if kind == 'tensor'
                 else (make_reader, jax_make_reader))
    kwargs = dict(deterministic=True, seed=7, num_epochs=2, reader_pool_type=pool,
                  workers_count=workers)
    got = _chunks(port, store, **kwargs)
    assert got == _chunks(jax, store, **kwargs)
    ids = [i for chunk, _ in got for i in chunk]
    assert sorted(ids) == sorted(list(range(ROWS)) * 2)
    assert got == _chunks(port, store, **dict(kwargs, workers_count=5 - workers))


def _batch_digests(batches, narrow=False):
    out = []
    for batch in batches:
        row = {}
        for name, value in dict(batch).items():
            arr = np.asarray(value)
            if narrow and arr.dtype == np.int64:
                arr = arr.astype(np.int32)     # the JAX loader's narrowing
            row[name] = (arr.shape, arr.dtype.str, _digest_array(arr))
        out.append(row)
    return out


@pytest.mark.parametrize('kind', ['tensor', 'row'])
def test_deterministic_loader_batches_equal_jax(store, kind):
    port, jax = ((make_tensor_reader, jax_make_tensor_reader) if kind == 'tensor'
                 else (make_reader, jax_make_reader))
    kwargs = dict(deterministic=True, seed=3, num_epochs=1, workers_count=3)
    with port(store, **kwargs) as reader:
        with TorchLoader(reader, BATCH, device='cpu', last_batch='pad') as loader:
            # Copies: on the CPU a batch aliases its arena until it is collected.
            got = _batch_digests([{k: v.numpy().copy() for k, v in b._asdict().items()}
                                  for b in loader], narrow=True)
    with jax(store, **kwargs) as reader:
        with JaxLoader(reader, BATCH, last_batch='pad') as loader:
            want = _batch_digests([{k: np.asarray(v) for k, v in b._asdict().items()}
                                   for b in loader])
    assert len(got) == -(-ROWS // BATCH) and got == want


# -- state_dict and resume across packages ---------------------------------------------

def _consume(reader, n):
    return [np.atleast_1d(next(reader).sample_id).tolist() for _ in range(n)]


@pytest.mark.parametrize('deterministic,pool', [(False, 'dummy'), (True, 'dummy'),
                                                (True, 'thread')])
@pytest.mark.parametrize('kind', ['tensor', 'row'])
def test_state_dict_after_k_equals_jax(store, kind, deterministic, pool):
    port, jax = ((make_tensor_reader, jax_make_tensor_reader) if kind == 'tensor'
                 else (make_reader, jax_make_reader))
    kwargs = dict(deterministic=deterministic, seed=5, num_epochs=2, reader_pool_type=pool,
                  workers_count=2)
    for k in (0, 3, 13):
        with port(store, **kwargs) as a, jax(store, **kwargs) as b:
            assert _consume(a, k) == _consume(b, k)
            got, want = a.state_dict(), b.state_dict()
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True), k


def _stream(factory, url, resume_state=None, **kwargs):
    ids = []
    with factory(url, resume_state=resume_state, **kwargs) as reader:
        for sample in reader:
            ids.extend(np.atleast_1d(sample.sample_id).tolist())
    return ids


@pytest.mark.parametrize('writer', ['jax', 'port'])
@pytest.mark.parametrize('kind', ['tensor', 'row'])
def test_cursor_of_one_package_resumes_the_other(store, kind, writer):
    """A cursor written mid-epoch (mid-chunk for the row reader) by one
    package resumes the other to the uninterrupted stream's remainder."""
    port, jax = ((make_tensor_reader, jax_make_tensor_reader) if kind == 'tensor'
                 else (make_reader, jax_make_reader))
    first, second = (jax, port) if writer == 'jax' else (port, jax)
    kwargs = dict(deterministic=True, seed=9, num_epochs=2, workers_count=3)
    full = _stream(port, store, **kwargs)
    k = 7 if kind == 'tensor' else 15
    with first(store, **kwargs) as reader:
        head = [i for chunk in _consume(reader, k) for i in chunk]
        state = json.loads(json.dumps(reader.state_dict()))
    assert state['mode'] == 'deterministic'
    assert head + _stream(second, store, resume_state=state, **kwargs) == full


def test_default_mode_state_resumes_the_other_package(store):
    """Default (multiset) mode: a JAX-written state resumes the port to the
    complement, and the reverse, on the dummy pool."""
    kwargs = dict(seed=2, num_epochs=1, reader_pool_type='dummy')
    for first, second in ((jax_make_tensor_reader, make_tensor_reader),
                          (make_tensor_reader, jax_make_tensor_reader)):
        with first(store, **kwargs) as reader:
            head = [i for chunk in _consume(reader, 4) for i in chunk]
            state = json.loads(json.dumps(reader.state_dict()))
        assert sorted(head + _stream(second, store, resume_state=state, **kwargs)) == \
            list(range(ROWS))


def test_resume_of_a_resume_continues_the_stream(store):
    kwargs = dict(deterministic=True, seed=4, num_epochs=2, workers_count=2)
    full = _stream(make_reader, store, **kwargs)
    seen, state = [], None
    for k in (11, 23, 5):
        with make_reader(store, resume_state=state, **kwargs) as reader:
            seen += [i for row in _consume(reader, k) for i in row]
            state = json.loads(json.dumps(reader.state_dict()))
    assert seen + _stream(make_reader, store, resume_state=state, **kwargs) == full


def test_reset_after_a_resume_reads_a_full_round(store):
    kwargs = dict(deterministic=True, seed=4, num_epochs=1, workers_count=2)
    full = _stream(make_tensor_reader, store, **kwargs)
    with make_tensor_reader(store, **kwargs) as reader:
        _consume(reader, 3)
        state = reader.state_dict()
    with make_tensor_reader(store, resume_state=state, **kwargs) as reader:
        tail = [i for s in reader for i in s.sample_id.tolist()]
        reader.reset()
        again = [i for s in reader for i in s.sample_id.tolist()]
    assert tail == full[len(full) - len(tail):] and again == full


# -- refusals ----------------------------------------------------------------------

def test_deterministic_cursor_is_refused_by_a_default_reader(store):
    with make_tensor_reader(store, deterministic=True, seed=1) as reader:
        _consume(reader, 2)
        state = reader.state_dict()
    for factory in (make_tensor_reader, jax_make_tensor_reader):
        with pytest.raises(ValueError, match='deterministic-mode stream cursor'):
            factory(store, seed=1, resume_state=state)


def test_unmerged_multi_shard_cursor_is_refused(store):
    with make_tensor_reader(store, deterministic=True, seed=1, cur_shard=1,
                            shard_count=2) as reader:
        _consume(reader, 1)
        state = reader.state_dict()
    assert (state['cur_shard'], state['shard_count']) == (1, 2)
    for factory in (make_tensor_reader, jax_make_tensor_reader):
        with pytest.raises(ValueError, match='merge_cursors'):
            factory(store, deterministic=True, seed=1, resume_state=state)
    merged = determinism.merge_cursors([state, dict(state, cur_shard=0)])
    with make_tensor_reader(store, deterministic=True, seed=1, resume_state=merged) as reader:
        assert next(reader) is not None


def test_deterministic_needs_a_pool_that_can_resequence(store):
    class PlainPool(object):
        workers_count = 1

        def start(self, *args):
            raise AssertionError('the reader must refuse before starting the pool')

    parquet = ParquetStore(store)
    from petastorm_tpu_torch.etl.dataset_metadata import get_schema
    with pytest.raises(ValueError, match='resequence'):
        Reader(parquet, get_schema(parquet), PlainPool(), worker_class=TensorWorker,
               deterministic=True)


def test_config_drift_warns_and_shuffle_rows_in_chunk_is_not_ported(store):
    with make_tensor_reader(store, seed=1, reader_pool_type='dummy') as reader:
        _consume(reader, 1)
        state = reader.state_dict()
    with pytest.warns(UserWarning, match='different reader configuration'):
        make_tensor_reader(store, seed=1, num_epochs=2, reader_pool_type='dummy',
                           resume_state=state).stop()
    # shuffle_rows_in_chunk is ported: it is part of the fingerprint, so a
    # resume that turns it on warns as drift.
    with pytest.warns(UserWarning, match='shuffle_rows_in_chunk'):
        make_tensor_reader(store, seed=1, reader_pool_type='dummy', resume_state=state,
                           shuffle_rows_in_chunk=True).stop()


# -- resharding ------------------------------------------------------------------------

def _chunk_ids(url, **kwargs):
    defaults = dict(shuffle_row_groups=True, seed=7, num_epochs=1, deterministic=True,
                    workers_count=3)
    defaults.update(kwargs)
    with make_tensor_reader(url, **defaults) as reader:
        return [chunk.sample_id.tolist() for chunk in reader]


@pytest.mark.parametrize('epochs', [1, 2])
def test_round_robin_of_shards_is_the_global_stream(store, epochs):
    single = _chunk_ids(store, num_epochs=epochs)
    for m in (2, 3):
        per = [_chunk_ids(store, num_epochs=epochs, cur_shard=h, shard_count=m)
               for h in range(m)]
        assert [per[j % m][j // m] for j in range(len(single))] == single, m
        jax_per = []
        for h in range(m):
            with jax_make_tensor_reader(store, shuffle_row_groups=True, seed=7,
                                        num_epochs=epochs, deterministic=True, workers_count=2,
                                        cur_shard=h, shard_count=m) as reader:
                jax_per.append([chunk.sample_id.tolist() for chunk in reader])
        assert jax_per == per


@pytest.mark.parametrize('before,after', [(1, 2), (2, 3), (3, 1), (2, 1)])
def test_resharded_resume_from_merged_cursors(store, before, after):
    """Checkpoint every host of a ``before``-shard job after the same number
    of chunks, merge, resume on ``after`` hosts: the round-robin of the
    resumed streams is the global stream from the merged cursor, the
    least-advanced host's frontier. A host's frontier is its own next
    position (the port's strided cursor), so hosts that consumed alike
    merge to exactly what they consumed and nothing re-delivers."""
    single = _chunk_ids(store, num_epochs=2)
    steps = 2
    states = []
    for h in range(before):
        with make_tensor_reader(store, shuffle_row_groups=True, seed=7, num_epochs=2,
                                deterministic=True, workers_count=2, cur_shard=h,
                                shard_count=before) as reader:
            _consume(reader, steps)
            states.append(json.loads(json.dumps(reader.state_dict())))
    merged = determinism.merge_cursors(states)
    assert merged == jax_det.merge_cursors(states)
    per = [_chunk_ids(store, num_epochs=2, resume_state=merged,
                      **({} if after == 1 else {'cur_shard': h, 'shard_count': after}))
           for h in range(after)]
    assert (merged['epoch'], merged['pos']) == (1, steps * before)
    rest = single[merged['pos']:]
    assert [per[j % after][j // after] for j in range(len(rest))] == rest


# -- the 2-host fold of tests/test_multichip_staging.py, through the port ------------

def _host_digests(url, pod_shard, stop_after=None, resume=None):
    """One simulated host's loader batches (batch = the chunk size, so host
    batch k is global chunk ``k * shard_count + cur_shard``): per-field CRC32
    digests, and the loader's state after ``stop_after`` batches."""
    from petastorm_tpu_torch import make_pod_reader
    reader = make_pod_reader(url, pod_shard=pod_shard, deterministic=True, seed=7,
                             num_epochs=1, shuffle_row_groups=True, reader_pool_type='thread',
                             workers_count=2, resume_state=resume)
    digests, state = [], None
    with reader:
        with TorchLoader(reader, PER_GROUP, device='cpu') as loader:
            for b in loader:
                digests.append(tuple(_digest_array(getattr(b, f).numpy())
                                     for f in sorted(b._fields)))
                if stop_after is not None and len(digests) >= stop_after:
                    state = loader.state_dict()
                    break
    return digests, state


@pytest.mark.parametrize('repetition', range(6))
def test_two_hosts_fold_to_one_resume(store, repetition):
    """Two ``make_pod_reader`` hosts over 2-worker thread pools each stop
    after 2 batches; ``merge_cursors`` folds their loader states and one
    host resumes: what the pair delivered, interleaved, then the resumed
    tail, is the single-host stream digest for digest, on every
    repetition (the JAX package's
    ``test_merge_cursors_two_hosts_to_one_resume``)."""
    single, _ = _host_digests(store, (0, 1))
    states, per_host = [], []
    for host in (0, 1):
        digests, state = _host_digests(store, (host, 2), stop_after=2)
        assert state is not None
        states.append(state)
        per_host.append(digests)
    consumed = [per_host[j % 2][j // 2] for j in range(4)]
    cursor = determinism.merge_cursors(states)
    assert cursor == jax_det.merge_cursors(states)
    tail, _ = _host_digests(store, (0, 1), resume=cursor)
    assert consumed + tail == single
