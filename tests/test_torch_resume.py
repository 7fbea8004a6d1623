"""Mid-epoch resume of the port's readers and loader: the cases of
``tests/test_checkpoint_resume.py`` (and the shuffling-buffer cases of
``tests/test_determinism.py``) that apply to ported surfaces, held to the
same contract: exactly once per epoch across a stop and resume (multiset
equality). Where a run is deterministic (the dummy pool), the state dicts
are JSON-equal to the JAX package's; the shuffling buffer replays the same
draws as the JAX buffer. All comparisons are exact.
"""

import json

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu.checkpoint import ConsumptionTracker as JaxTracker
from petastorm_tpu.jax_loader import JaxLoader
from petastorm_tpu.shuffling_buffer import RandomShufflingBuffer as JaxShufflingBuffer
from petastorm_tpu_torch import (NdarrayCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, make_reader, make_tensor_reader, write_dataset)
from petastorm_tpu_torch.checkpoint import ConsumptionTracker
from petastorm_tpu_torch.loader import _iter_batches
from petastorm_tpu_torch.shuffling_buffer import RandomShufflingBuffer

ROWS, PER_GROUP = 50, 10


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    schema = Unischema('ResumeSchema', [
        UnischemaField('id', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('matrix', np.float32, (3, 3), NdarrayCodec(), False),
    ])
    rng = np.random.default_rng(2)
    url = 'file://' + str(tmp_path_factory.mktemp('resume') / 'store')
    write_dataset(url, schema, ({'id': i, 'matrix': rng.random((3, 3), dtype=np.float32)}
                                for i in range(ROWS)), rows_per_row_group=PER_GROUP)
    return url


ALL_IDS = list(range(ROWS))


def _ids(reader, n):
    return [int(next(reader).id) for _ in range(n)]


def _rest_ids(reader):
    return [i for sample in reader for i in np.atleast_1d(sample.id).tolist()]


def _same_json(a, b):
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def _consumed(state):
    """A loader state without the keys of chunks that were only prefetched
    (how many depends on the staging threads' timing)."""
    return dict(state, keys={k: v for k, v in state['keys'].items() if v['done'] or v['partial']})


# -- readers ------------------------------------------------------------------------

def test_dummy_pool_exact_resume(store):
    """Part of an epoch, then a resume: exactly the complement; the state is
    JSON-equal to the JAX reader's after the same rows."""
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    with make_reader(store, **kwargs) as reader, jax_make_reader(store, **kwargs) as jax_reader:
        first = _ids(reader, 37)
        assert _ids(jax_reader, 37) == first
        state = json.loads(json.dumps(reader.state_dict()))
        assert _same_json(state, jax_reader.state_dict())
    with make_reader(store, resume_state=state, **kwargs) as reader:
        rest = _rest_ids(reader)
    assert sorted(first + rest) == ALL_IDS and not set(first) & set(rest)


def test_thread_pool_multiset_exactness(store):
    kwargs = dict(reader_pool_type='thread', workers_count=3, shuffle_row_groups=True, seed=11)
    with make_reader(store, **kwargs) as reader:
        first = _ids(reader, 41)
        state = reader.state_dict()
    with make_reader(store, resume_state=state, **kwargs) as reader:
        rest = _rest_ids(reader)
    assert sorted(first + rest) == ALL_IDS


@pytest.mark.parametrize('kind', ['row', 'tensor'])
def test_mid_rowgroup_partial_resume(store, kind):
    """Stopping inside a row-group resumes at its exact row offset (the
    tensor reader through a loader with row-granular accounting)."""
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    if kind == 'row':
        with make_reader(store, **kwargs) as reader:
            first = _ids(reader, 3)
            state = reader.state_dict()
    else:
        with make_tensor_reader(store, **kwargs) as reader:
            with TorchLoader(reader, 3, device='cpu', prefetch=0) as loader:
                first = next(loader).id.tolist()
                state = loader.state_dict()
    assert [e for e in state['keys'].values() if e['partial']] != []
    factory = make_reader if kind == 'row' else make_tensor_reader
    with factory(store, resume_state=state, **kwargs) as reader:
        rest = _rest_ids(reader)
    assert sorted(first + rest) == ALL_IDS


def test_infinite_epochs_balance(store):
    """``num_epochs=None``: a resume keeps per-sample balance (spread <= 2)."""
    kwargs = dict(reader_pool_type='thread', workers_count=2, num_epochs=None, seed=3)
    counts = dict.fromkeys(ALL_IDS, 0)
    with make_reader(store, **kwargs) as reader:
        for i in _ids(reader, int(ROWS * 1.5)):
            counts[i] += 1
        state = reader.state_dict()
    with make_reader(store, resume_state=state, **kwargs) as reader:
        for i in _ids(reader, ROWS):
            counts[i] += 1
    assert min(counts.values()) >= 1 and max(counts.values()) - min(counts.values()) <= 2


def test_config_mismatch_warns(store):
    with make_reader(store, reader_pool_type='dummy') as reader:
        next(reader)
        state = reader.state_dict()
    with pytest.warns(UserWarning, match='different reader configuration'):
        with make_reader(store, reader_pool_type='dummy', num_epochs=2,
                         resume_state=state) as reader:
            next(reader)


def test_fresh_state_is_a_no_op(store):
    with make_reader(store, reader_pool_type='dummy') as reader:
        state = reader.state_dict()
    with jax_make_reader(store, reader_pool_type='dummy') as reader:
        assert _same_json(state, reader.state_dict())
    assert state['keys'] == {}
    with make_reader(store, reader_pool_type='dummy', resume_state=state) as reader:
        assert len(list(reader)) == ROWS


def _tracker_events(cls):
    """``tests/test_checkpoint_resume.py::test_tracker_resume_of_resume``'s
    chain, every return and state recorded."""
    log = []
    t1 = cls()
    log.append(t1.on_chunk('0:0', 4))
    t1.rows_yielded('0:0', 4)
    log.append(t1.state_dict())
    t2 = cls(log[-1], num_epochs=2)
    log.append(t2.on_chunk('0:0', 4))
    log.append(t2.state_dict())
    t3 = cls(log[-1], num_epochs=2)
    log.append(t3.on_chunk('0:0', 4))
    t3.rows_yielded('0:0', 0)
    log.append(t3.on_chunk('0:0', 4))
    t3.rows_yielded('0:0', 4)
    log.append(t3.state_dict())
    t4 = cls({'version': 1, 'keys': {'0:0': {'done': 3, 'partial': 1, 'total': 4},
                                     '1:0': {'done': 1, 'partial': 0, 'total': 4}}},
             num_epochs=None)
    log += [t4.on_chunk('0:0', 4), t4.on_chunk('0:0', 4), t4.on_chunk('1:0', 4),
            t4.state_dict()]
    return log


def test_tracker_resume_of_resume_equals_jax():
    log = _tracker_events(ConsumptionTracker)
    assert log == _tracker_events(JaxTracker)
    assert log[3]['keys']['0:0']['done'] == 1 and log[6]['keys']['0:0']['done'] == 2
    with pytest.raises(ValueError, match='version'):
        ConsumptionTracker({'version': 7, 'keys': {}})


# -- the loader ----------------------------------------------------------------------

def test_row_reader_loader_state_counts_buffered_rows_consumed(store):
    """A per-row reader counts a row when it leaves the reader: nothing of
    the delivered batch comes back (rows the loader held count consumed)."""
    kwargs = dict(reader_pool_type='thread', workers_count=2, seed=7)
    with make_reader(store, **kwargs) as reader:
        with TorchLoader(reader, 10, device='cpu') as loader:
            seen = next(loader).id.tolist()
            state = loader.state_dict()
    assert state['keys']
    with make_reader(store, resume_state=state, **kwargs) as reader:
        rest = _rest_ids(reader)
    assert not set(seen) & set(rest)


@pytest.mark.parametrize('prefetch', [0, 2])
def test_tensor_loader_row_granular_resume(store, prefetch):
    """Consumption counts when batches are delivered, not when chunks leave
    the reader: rows staged beyond the delivered batches re-deliver. With the
    dummy pool the consumed part of the state is JSON-equal to
    ``JaxLoader``'s."""
    kwargs = dict(reader_pool_type='dummy', num_epochs=1, shuffle_row_groups=False)
    with make_tensor_reader(store, **kwargs) as reader:
        with TorchLoader(reader, 7, device='cpu', prefetch=prefetch, inflight=1) as loader:
            seen = [i for _ in range(3) for i in next(loader).id.tolist()]
            state = json.loads(json.dumps(loader.state_dict()))
    with jax_make_tensor_reader(store, **kwargs) as reader:
        with JaxLoader(reader, 7, prefetch=max(prefetch, 1), last_batch='drop') as loader:
            want = [i for _ in range(3) for i in np.asarray(next(loader).id).tolist()]
            assert _same_json(_consumed(state), _consumed(loader.state_dict()))
    assert seen == want and len(seen) == 21
    with make_tensor_reader(store, resume_state=state, **kwargs) as reader:
        rest = _rest_ids(reader)
    assert sorted(seen + rest) == ALL_IDS and not set(seen) & set(rest)


def test_superbatch_partial_group_not_counted_consumed(store):
    """50 rows, batch 5, k 3: three groups (45 rows); the dropped lone batch's
    rows re-deliver."""
    kwargs = dict(reader_pool_type='thread', workers_count=2, num_epochs=1,
                  shuffle_row_groups=False)
    with make_tensor_reader(store, **kwargs) as reader:
        with TorchLoader(reader, 5, device='cpu') as loader:
            seen = [i for group in loader.superbatches(3) for i in group.id.tolist()]
            state = json.loads(json.dumps(loader.state_dict()))
    assert len(seen) == 45
    with make_tensor_reader(store, resume_state=state, **kwargs) as reader:
        rest = _rest_ids(reader)
    assert sorted(seen + rest) == ALL_IDS and not set(seen) & set(rest)


def test_echo_superbatch_checkpoint_exactness(store):
    """echo 2 under superbatches(2): a group is one fresh batch and its echo;
    only the fresh rows count."""
    kwargs = dict(reader_pool_type='dummy', num_epochs=1, shuffle_row_groups=False)
    with make_tensor_reader(store, **kwargs) as reader:
        with TorchLoader(reader, 5, device='cpu', echo=2) as loader:
            group = next(loader.superbatches(2))
            seen = set(group.id.tolist())
            state = json.loads(json.dumps(loader.state_dict()))
    with jax_make_tensor_reader(store, **kwargs) as reader:
        with JaxLoader(reader, 5, echo=2, last_batch='drop') as loader:
            next(loader.superbatches(2))
            assert _same_json(_consumed(state), _consumed(loader.state_dict()))
    assert seen == set(range(5)) and group.id.tolist() == list(range(5)) * 2
    with make_tensor_reader(store, resume_state=state, **kwargs) as reader:
        rest = _rest_ids(reader)
    assert sorted(list(seen) + rest) == ALL_IDS


def test_abandoned_superbatch_then_direct_iteration(store):
    kwargs = dict(reader_pool_type='dummy', num_epochs=1, shuffle_row_groups=False)
    with make_tensor_reader(store, **kwargs) as reader:
        with TorchLoader(reader, 5, device='cpu') as loader:
            groups = loader.superbatches(2)
            seen = set(next(groups).id.tolist())
            del groups
            seen.update(next(loader).id.tolist())
            state = json.loads(json.dumps(loader.state_dict()))
    with make_tensor_reader(store, resume_state=state, **kwargs) as reader:
        rest = _rest_ids(reader)
    assert seen == set(range(15)) and sorted(list(seen) + rest) == ALL_IDS


# -- the shuffling buffer's checkpoint ---------------------------------------------------

def test_shuffling_buffer_state_round_trip_replays_jax_draws():
    """The port's buffer and the JAX buffer draw the same rows from one
    seed; a snapshot of either restores into the other and both continue
    the same draws."""
    port, jax = RandomShufflingBuffer(200, 20, seed=9), JaxShufflingBuffer(200, 20, seed=9)
    for buf in (port, jax):
        buf.add_many(list(range(100)))
    assert [port.retrieve() for _ in range(40)] == [jax.retrieve() for _ in range(40)]
    state, jax_state = port.state_dict(), jax.state_dict()
    assert state == jax_state and state['size'] == 60
    restored, jax_restored = RandomShufflingBuffer(200, 20, seed=1), JaxShufflingBuffer(200, 20)
    restored.restore(jax_state)
    jax_restored.restore(state)
    draws = [[b.retrieve() for _ in range(30)] for b in (port, jax, restored, jax_restored)]
    assert all(d == draws[0] for d in draws)
    with pytest.raises(ValueError, match='version'):
        restored.restore({'version': 99})


def test_pending_draws_ride_the_snapshot():
    """With ``track_pending`` the rows drawn but not yet delivered come back
    first in the snapshot, as in the JAX buffer."""
    port, jax = RandomShufflingBuffer(50, 5, seed=4), JaxShufflingBuffer(50, 5, seed=4)
    for buf in (port, jax):
        buf.track_pending()
        buf.add_many(list(range(30)))
        [buf.retrieve() for _ in range(10)]
        buf.mark_delivered(6)
    assert port.state_dict() == jax.state_dict() and port.state_dict()['size'] == 24


def test_loader_shuffling_buffer_survives_checkpoint(store):
    """Buffered and drawn-but-undelivered rows ride the loader's state: head
    and resumed tail are the epoch exactly; a loader rebuilt without a
    buffer refuses the snapshot."""
    def build(resume=None):
        reader = make_tensor_reader(store, shuffle_row_groups=True, seed=7, num_epochs=1,
                                    deterministic=True, workers_count=2, resume_state=resume)
        return reader, TorchLoader(reader, 10, device='cpu', prefetch=2, seed=3,
                                   shuffling_queue_capacity=30, last_batch='partial',
                                   resume_state=resume)

    reader, loader = build()
    with reader, loader:
        head = [i for _ in range(2) for i in next(loader).id.tolist()]
        state = loader.state_dict()
    assert state['shuffling_buffer']['size'] > 0
    reader, loader = build(resume=state)
    with reader, loader:
        tail = [i for batch in loader for i in batch.id.tolist()]
    assert sorted(head + tail) == ALL_IDS
    with make_tensor_reader(store, seed=7, deterministic=True, resume_state=state) as reader:
        with pytest.raises(ValueError, match='shuffling_queue_capacity'):
            TorchLoader(reader, 10, device='cpu', resume_state=state)


def test_restored_buffer_drains_without_any_fresh_sample():
    """A resumed reader that yields nothing: the snapshot's field names
    attribute the restored rows; without them the drain raises."""
    donor = RandomShufflingBuffer(30, 5, seed=1)
    donor.field_names = ['id', 'vec']
    donor.add_many([(i, np.full(4, i, dtype=np.float32)) for i in range(12)])
    snapshot = donor.state_dict()

    class EmptyReader(object):
        batched_output = False

        def __iter__(self):
            return iter(())

    restored = RandomShufflingBuffer(30, 5, seed=1)
    restored.restore(snapshot)
    batches = [b for b, _ in _iter_batches(EmptyReader(), 4, shuffler=restored,
                                           last_batch='partial')]
    assert sum(len(b['id']) for b in batches) == 12
    assert all(set(b) == {'id', 'vec'} for b in batches)
    fresh = RandomShufflingBuffer(30, 5, seed=1)
    fresh.restore(dict(snapshot, field_names=None))
    with pytest.raises(ValueError, match='field names'):
        list(_iter_batches(EmptyReader(), 4, shuffler=fresh, last_batch='partial'))
