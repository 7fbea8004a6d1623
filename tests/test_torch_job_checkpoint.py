"""The port's whole-job checkpointer (``torch.distributed.checkpoint``)
against the contract of ``petastorm_tpu/job_checkpoint.py`` on the CPU: a
ResNetTiny ``TrainState`` after two SGD steps round-trips bit for bit
(params, BatchNorm buffers, momentum buffers, step), the loader state
(shuffling-buffer rows included) rides the same artifact, retention and the
save interval work as orbax's, async saves are durable after ``wait()``, a
torn step directory is invisible, and the preemptible example sees every
row as the JAX example does.
"""

import json
import os

import numpy as np
import pytest
import torch

from petastorm_tpu import job_checkpoint as jax_job_checkpoint
from petastorm_tpu_torch import TorchLoader, make_tensor_reader
from petastorm_tpu_torch.job_checkpoint import (FINISHED_MARKER, JobCheckpointer,
                                                _decode_loader_state, _encode_loader_state)
from petastorm_tpu_torch.models import ResNetTiny, create_train_state, make_train_step


def _trained_state(seed=0, steps=2):
    torch.manual_seed(seed)
    state = create_train_state(ResNetTiny(num_classes=10, device='cpu'), learning_rate=0.1,
                               momentum=0.9)
    step = make_train_step()
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        step(state, torch.rand((4, 16, 16, 3), generator=g),
             torch.randint(0, 10, (4,), generator=g))
    return state


def _fresh_state():
    return _trained_state(seed=1, steps=0)


def _assert_bit_equal(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb)
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    assert any('running_var' in name for name in sa)
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(a.optimizer.state[p]['momentum_buffer'],
                           b.optimizer.state[q]['momentum_buffer']), name


def test_train_state_round_trips_bit_equal(tmp_path):
    state = _trained_state()
    assert state.step == 2
    with JobCheckpointer(str(tmp_path)) as ckpt:
        assert ckpt.save(2, state, extra={'epoch': 0, 'lr': 0.1})
        assert ckpt.latest_step() == 2 and ckpt.all_steps() == [2]
    fresh = _fresh_state()
    assert not fresh.optimizer.state            # momentum buffers are made lazily
    with JobCheckpointer(str(tmp_path)) as ckpt:
        job = ckpt.restore(fresh)
    assert (job.step, job.extra, job.loader_state) == (2, {'epoch': 0, 'lr': 0.1}, None)
    assert job.state is fresh
    _assert_bit_equal(state, fresh)
    assert 'step=2' in repr(job)


def test_restore_in_place_keeps_every_tensor(tmp_path):
    """Restored into the live state, values come back and no tensor moves
    (a graph captured on the state stays valid)."""
    state = _trained_state()
    snapshot = _trained_state()
    with JobCheckpointer(str(tmp_path)) as ckpt:
        ckpt.save(2, state)
        make_train_step()(state, torch.rand((4, 16, 16, 3)), torch.randint(0, 10, (4,)))
        ptrs = [t.data_ptr() for t in state.model.state_dict().values()] + \
            [s['momentum_buffer'].data_ptr() for s in state.optimizer.state.values()]
        ckpt.restore(state)
    assert ptrs == [t.data_ptr() for t in state.model.state_dict().values()] + \
        [s['momentum_buffer'].data_ptr() for s in state.optimizer.state.values()]
    _assert_bit_equal(snapshot, state)


def test_loader_state_rides_the_checkpoint(tmp_path):
    """A loader with a shuffling buffer: its state (buffered numpy rows and
    the generator state, not JSON-safe) round-trips through the artifact
    and resumes the epoch exactly."""
    from petastorm_tpu_torch import NdarrayCodec, ScalarCodec, Unischema, UnischemaField
    from petastorm_tpu_torch import write_dataset
    schema = Unischema('Ckpt', [UnischemaField('id', np.int64, (), ScalarCodec(np.int64), False),
                                UnischemaField('x', np.float32, (2,), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path / 'store')
    write_dataset(url, schema, ({'id': i, 'x': np.full(2, i, np.float32)} for i in range(40)),
                  rows_per_row_group=8)

    def build(resume=None):
        reader = make_tensor_reader(url, seed=2, deterministic=True, workers_count=2,
                                    resume_state=resume)
        return reader, TorchLoader(reader, 8, device='cpu', shuffling_queue_capacity=16, seed=5,
                                   last_batch='partial', resume_state=resume)

    state = _trained_state()
    reader, loader = build()
    with reader, loader, JobCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
        head = next(loader).id.tolist()
        saved = loader.state_dict()      # a state taken already is saved as it is
        ckpt.save(1, state, loader=saved)
    assert saved['shuffling_buffer']['rows']
    with JobCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
        job = ckpt.restore(_fresh_state())
    restored_rows = job.loader_state['shuffling_buffer']['rows']
    assert len(restored_rows) == len(saved['shuffling_buffer']['rows'])
    assert all(a[0] == b[0] and np.array_equal(a[1], b[1])
               for a, b in zip(restored_rows, saved['shuffling_buffer']['rows']))
    reader, loader = build(job.loader_state)
    with reader, loader:
        tail = [i for batch in loader for i in batch.id.tolist()]
    assert sorted(head + tail) == list(range(40))


def test_loader_state_encoding_matches_jax():
    """JSON-safe states ride as JSON, others as base64 pickle, as the JAX
    package encodes them; either package decodes the other's entry."""
    json_state = {'version': 1, 'keys': {'0:0': {'done': 1, 'partial': 0, 'total': 8}}}
    odd = {'rows': [(1, np.arange(3))], 'keys': {1: 2}}
    for state in (json_state, odd, None):
        port, jax = _encode_loader_state(state), jax_job_checkpoint._encode_loader_state(state)
        assert (port == jax) if state is not odd else (set(port) == set(jax))
        for entry in (port, jax):
            back = _decode_loader_state(json.loads(json.dumps(entry)))
            if state is odd:
                assert back['keys'] == {1: 2} and np.array_equal(back['rows'][0][1], np.arange(3))
            else:
                assert back == (state or {})


def test_restore_returns_none_without_a_checkpoint(tmp_path):
    with JobCheckpointer(str(tmp_path / 'empty')) as ckpt:
        assert ckpt.latest_step() is None and ckpt.restore(_fresh_state()) is None
        ckpt.save(3, _trained_state())
        assert ckpt.restore(_fresh_state(), step=2) is None
        assert ckpt.restore(_fresh_state(), step=3).step == 3


def test_retention_and_interval(tmp_path):
    state = _trained_state()
    with JobCheckpointer(str(tmp_path), max_to_keep=2, save_interval_steps=2) as ckpt:
        saved = [ckpt.save(step, state) for step in range(7)]
        assert saved == [True, False, True, False, True, False, True]
        assert ckpt.all_steps() == [4, 6]
        assert not ckpt.save(5, state) and not ckpt.save(6, state)   # not past the latest
        assert ckpt.save(7, state, force=True)                        # off the interval
        assert ckpt.all_steps() == [6, 7]
        with pytest.raises(FileExistsError):
            ckpt.save(7, state, force=True)
    with JobCheckpointer(str(tmp_path), max_to_keep=None) as ckpt:
        assert not ckpt.save(7, state) and ckpt.save(8, state)
        assert ckpt.all_steps() == [6, 7, 8]
    with pytest.raises(ValueError, match='save_interval_steps'):
        JobCheckpointer(str(tmp_path), save_interval_steps=0)


def test_async_saves_are_durable_after_wait(tmp_path):
    """The state is copied at save(); training that continues cannot reach
    the artifact, which is whole once wait() returns."""
    state = _trained_state()
    snapshot = _trained_state()
    ckpt = JobCheckpointer(str(tmp_path), max_to_keep=3, async_save=True)
    try:
        for step in (1, 2, 3):
            assert ckpt.save(step, state, extra={'step': step})
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)                             # after the save, before the write
        ckpt.wait()
        assert ckpt.all_steps() == [1, 2, 3]
    finally:
        ckpt.close()
    with pytest.raises(RuntimeError, match='closed'):
        ckpt.save(4, state)
    with JobCheckpointer(str(tmp_path)) as reader:
        job = reader.restore(_fresh_state())
    assert job.extra == {'step': 3}
    _assert_bit_equal(snapshot, job.state)


def test_torn_step_directory_is_ignored(tmp_path):
    state = _trained_state()
    with JobCheckpointer(str(tmp_path)) as ckpt:
        ckpt.save(1, state)
    os.makedirs(str(tmp_path / '5'))                      # a step that never finished
    with open(str(tmp_path / '5' / '.metadata'), 'w') as f:
        f.write('torn')
    os.makedirs(str(tmp_path / '.tmp-9-abc'))             # an interrupted write
    with JobCheckpointer(str(tmp_path)) as ckpt:
        assert ckpt.all_steps() == [1] and ckpt.latest_step() == 1
        assert ckpt.restore(_fresh_state(), step=5) is None
        assert ckpt.restore(_fresh_state()).step == 1
        assert ckpt.save(5, state)                         # replaces the torn directory
        assert os.path.exists(str(tmp_path / '5' / FINISHED_MARKER))
        assert ckpt.latest_step() == 5


def test_preemptible_example_sees_every_row_like_jax(tmp_path):
    """The port's example and the JAX one, same arguments: both resume at
    step 2, see all 128 rows, and re-deliver at most one batch."""
    from examples.preemptible.train_resume_example import run as jax_run
    from petastorm_tpu_torch.examples.preemptible import run

    results = {}
    for name, fn, kwargs in (('port', run, {'device': 'cpu'}), ('jax', jax_run, {})):
        losses, seen, restored = fn(dataset_url='file://' + str(tmp_path / name / 'ds'),
                                    ckpt_dir=str(tmp_path / name / 'ckpt'), batch=16,
                                    preempt_after=3, n_rows=128, **kwargs)
        assert all(np.isfinite(loss) for loss in losses)
        results[name] = (restored, sorted(set(seen)), len(seen) - len(set(seen)) <= 16,
                         len(losses))
    assert results['port'] == results['jax']
    assert results['port'][:3] == (2, list(range(128)), True)


# -- sharded: a mesh state over two gloo ranks ----------------------------------

SHARDED_AXES = {'data': 1, 'model': 2}


@pytest.fixture(scope='module')
def sharded_run(tmp_path_factory):
    import torch_mesh_ranks
    from petastorm_tpu_torch.parallel.launch import spawn
    directory = str(tmp_path_factory.mktemp('sharded'))
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 4).astype(np.int64)
    return directory, spawn(torch_mesh_ranks.checkpoint_save, 2,
                            (SHARDED_AXES, directory, x, labels), timeout=90)


@pytest.mark.timeout(200)
def test_sharded_save_writes_each_ranks_shards(sharded_run):
    directory, results = sharded_run
    assert results[0]['placements'] == {'head.weight': ('model', None),
                                        'head.bias': ('model',)}
    step_dir = os.path.join(directory, '1')
    names = sorted(os.listdir(step_dir))
    assert FINISHED_MARKER in names and '.metadata' in names
    assert len([n for n in names if n.endswith('.distcp')]) == 2
    with open(os.path.join(step_dir, FINISHED_MARKER)) as f:
        assert json.load(f)['loader_ranks'] == 2


@pytest.mark.timeout(200)
def test_sharded_restore_on_the_same_mesh_is_bit_equal(sharded_run):
    _, results = sharded_run
    for rank, res in enumerate(results):
        for name, value in res['state'].items():
            np.testing.assert_array_equal(res['restored'][name], value, err_msg=name)
        for name, value in res['momenta'].items():
            np.testing.assert_array_equal(res['restored_momenta'][name], value, err_msg=name)
        assert res['loader_state'] == {'rank': rank, 'pos': 10 + rank}
        assert res['loader_states'] == [{'rank': 0, 'pos': 10}, {'rank': 1, 'pos': 11}]
        assert (res['step'], res['extra']) == (1, {'tag': 'x'})


@pytest.mark.timeout(200)
def test_sharded_restore_on_one_rank_reshards_bit_equal(sharded_run):
    """A state without a mesh (the whole model, one process) restores every
    tensor at its global value: the shards concatenated."""
    import torch_mesh_ranks
    directory, results = sharded_run
    state = _fresh_state()
    with JobCheckpointer(directory) as ckpt:
        job = ckpt.restore(state)
    assert job.loader_state is None
    assert job.loader_states == [{'rank': 0, 'pos': 10}, {'rank': 1, 'pos': 11}]
    got = state.model.state_dict()
    for name in got:
        want = torch_mesh_ranks.full_from_shards(results, name, mesh_axes=SHARDED_AXES)
        np.testing.assert_array_equal(got[name].numpy(), want, err_msg=name)
    for name, p in state.model.named_parameters():
        want = torch_mesh_ranks.full_from_shards(results, name, value_key='momenta',
                                                 mesh_axes=SHARDED_AXES)
        np.testing.assert_array_equal(state.optimizer.state[p]['momentum_buffer'].numpy(), want,
                                      err_msg=name)


@pytest.mark.timeout(200)
def test_sharded_save_on_a_one_rank_group_round_trips(tmp_path):
    """A mesh state in a group of one rank (the card's world size) takes the
    sharded path: DTensor views, the per-rank loader file, bit-equal."""
    import torch_mesh_ranks
    from petastorm_tpu_torch.parallel.launch import spawn
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    (res,) = spawn(torch_mesh_ranks.checkpoint_save, 1,
                   ({'data': 1, 'model': 1}, str(tmp_path), x, rng.integers(0, 10, 2)),
                   timeout=90)
    assert os.path.exists(os.path.join(str(tmp_path), '1', 'loader-rank0.json'))
    for name, value in res['state'].items():
        np.testing.assert_array_equal(res['restored'][name], value, err_msg=name)
    assert res['loader_state'] == {'rank': 0, 'pos': 10}
