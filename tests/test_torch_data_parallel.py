"""Data and tensor parallelism of the port on gloo ranks, held against the
JAX package's ``make_train_step(mesh)`` on its virtual CPU devices, and the
pod guard under a real two-rank vote.

ResNetTiny, f32, 64x64 images, a global batch of 8: two momentum-SGD steps
on ``{'data': 2}`` (2 ranks) and ``{'data': 2, 'model': 2}`` (4 ranks, the
head split by column). Losses ``rtol=1e-4``; updated params and batch
statistics ``rtol=1e-4, atol=1e-5`` (the two BatchNorm variance formulas
round differently, as in ``test_torch_resnet.py``). Each spawned group
serves every case of its mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import NamedSharding

import torch_mesh_ranks
from petastorm_tpu.models import resnet as jax_resnet
from petastorm_tpu.models import train as jax_train
from petastorm_tpu.models.transformer import TransformerLM as JaxLM
from petastorm_tpu.parallel import make_mesh as jax_make_mesh
from petastorm_tpu_torch.convert import resnet_params_from_flax
from petastorm_tpu_torch.models import train as port_train
from petastorm_tpu_torch.models.transformer import TransformerLM
from petastorm_tpu_torch.parallel.launch import spawn

MESHES = {'dp': {'data': 2}, 'dp_tp': {'data': 2, 'model': 2}}


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree).items()}


def _variables():
    model = jax_resnet.ResNetTiny(num_classes=10, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    x = rng.normal(0.0, 1.0, (8, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 8).astype(np.int64)
    variables = model.init(jax.random.PRNGKey(3), jnp.asarray(x), train=False)

    def jitter(path, leaf):
        leaf = np.asarray(leaf)
        if getattr(path[-1], 'key', None) == 'var':
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32))
        return jnp.asarray(leaf + rng.normal(0.0, 0.1, leaf.shape).astype(np.float32))

    variables = {col: jax.tree_util.tree_map_with_path(jitter, tree)
                 for col, tree in variables.items()}
    return model, variables, x, labels


def _jax_steps(axes, steps=2):
    model, variables, x, labels = _variables()
    # The JAX step donates its state: keep numpy copies of the start.
    start = (_flat(variables['params']), _flat(variables['batch_stats']))
    mesh = jax_make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
    state = jax_train.TrainState.create(apply_fn=model.apply, params=variables['params'],
                                        tx=optax.sgd(0.1, momentum=0.9),
                                        batch_stats=variables['batch_stats'])
    state = jax.tree_util.tree_map_with_path(
        lambda p, leaf: jax.device_put(leaf, NamedSharding(
            mesh, jax_train._param_spec(p, leaf, mesh))), state)
    step = jax_train.make_train_step(mesh=mesh)
    metrics = []
    for i in range(steps):
        xi = x[::-1].copy() if i else x
        li = labels[::-1].copy() if i else labels
        state, m = step(state, jnp.asarray(xi), jnp.asarray(li.astype(np.int32)))
        metrics.append((float(m['loss']), float(m['accuracy'])))
    want = resnet_params_from_flax(_flat(state.params), _flat(state.batch_stats))
    return start, x, labels, metrics, {k: v.numpy() for k, v in want.items()}


@pytest.fixture(scope='module')
def runs():
    out = {}
    for name, axes in MESHES.items():
        (params, batch_stats), x, labels, metrics, want = _jax_steps(axes)
        results = spawn(torch_mesh_ranks.resnet_steps, int(np.prod(list(axes.values()))),
                        (axes, params, batch_stats, x, labels, 2), timeout=100)
        out[name] = (axes, metrics, want, results)
    out['pod'] = spawn(torch_mesh_ranks.pod_guard_cases, 2, timeout=60)
    return out


@pytest.mark.timeout(240)
@pytest.mark.parametrize('mesh', sorted(MESHES))
def test_losses_match_jax(runs, mesh):
    _, metrics, _, results = runs[mesh]
    for res in results:
        for (loss, acc), (jloss, jacc) in zip(res['metrics'], metrics):
            np.testing.assert_allclose(loss, jloss, rtol=1e-4)
            assert acc == pytest.approx(jacc)


@pytest.mark.timeout(240)
@pytest.mark.parametrize('mesh', sorted(MESHES))
def test_updated_params_match_jax(runs, mesh):
    axes, _, want, results = runs[mesh]
    for name, value in want.items():
        got = torch_mesh_ranks.full_from_shards(results, name, mesh_axes=axes)
        np.testing.assert_allclose(got, value, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.timeout(240)
def test_head_is_split_by_column_over_model(runs):
    axes, _, want, results = runs['dp_tp']
    assert results[0]['placements'] == {'head.weight': ('model', None), 'head.bias': ('model',)}
    assert results[0]['state']['head.weight'].shape == (5,) + want['head.weight'].shape[1:]
    assert runs['dp'][3][0]['placements'] == {}


@pytest.mark.timeout(240)
def test_replicas_hold_the_same_values(runs):
    """Ranks that differ only on 'data' hold identical params and stats."""
    _, _, _, results = runs['dp_tp']
    for name, value in results[0]['state'].items():
        np.testing.assert_array_equal(results[2]['state'][name], value, err_msg=name)


class _Mesh(object):
    """The part of a ``DeviceMesh`` a spec function reads."""

    def __init__(self, axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = list(axes.values())

    def size(self, dim):
        return self._sizes[dim]


@pytest.mark.parametrize('classes,n,split', [(10, 2, True), (10, 4, False), (12, 4, True)])
def test_head_spec_splits_only_what_divides(classes, n, split):
    mesh = _Mesh({'data': 1, 'model': n})
    spec = port_train._param_spec('head.weight', torch.empty(classes, 8), mesh)
    assert spec == (('model', None) if split else None)
    assert port_train._param_spec('conv_init.weight', torch.empty(8, 3, 7, 7), mesh) is None
    assert port_train._param_spec('head.weight', torch.empty(classes, 8), _Mesh({'data': 2})) \
        is None


@pytest.mark.parametrize('heads,n', [(4, 2), (4, 4), (6, 4), (2, 4)])
def test_transformer_spec_splits_what_jax_splits(heads, n):
    """Every kernel of the TransformerLM is split iff JAX's
    ``transformer_param_spec`` splits the flax leaf it comes from (a leaf
    that does not divide stays whole on both sides)."""
    d, vocab = 8 * heads, 40
    jax_model = JaxLM(vocab_size=vocab, d_model=d, num_heads=heads, num_layers=1, max_len=8,
                      dtype=jnp.float32)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params']
    jax_mesh = jax_make_mesh({'data': 8 // n, 'model': n})
    jax_split = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        names = tuple(str(getattr(p, 'key', '')) for p in path)
        jax_split[names] = any(jax_train.transformer_param_spec(path, leaf, jax_mesh))
    model = TransformerLM(vocab, d, heads, 1, max_len=8, dtype=torch.float32, device='cpu')
    mesh = _Mesh({'data': 8 // n, 'model': n})
    port_names = {'query': 'attn/query', 'key': 'attn/key', 'value': 'attn/value',
                  'out': 'attn/out', 'mlp_in': 'Dense_0', 'mlp_out': 'Dense_1'}
    checked = 0
    for name, param in model.named_parameters():
        module = model.get_submodule(name.rpartition('.')[0])
        spec = port_train.transformer_param_spec(name, param, mesh, module)
        parts = name.split('.')
        if parts[-1] != 'weight' or parts[0] not in ('blocks', 'head'):
            continue
        if parts[0] == 'head':
            key = ('head', 'kernel')
        else:
            flax_path = port_names[parts[-2]].split('/')
            key = ('block_0',) + tuple(flax_path) + ('kernel',)
        assert (spec is not None) == jax_split[key], (name, spec)
        checked += 1
    assert checked == 7


@pytest.mark.timeout(240)
def test_pod_guard_peer_failure_aborts_the_healthy_rank(runs):
    healthy, failed = runs['pod']
    assert healthy['peer_failure'] == ('abort', [0])
    assert failed['peer_failure'] == ('own', [0], 'rank 1 input died')


@pytest.mark.timeout(240)
def test_pod_guard_uneven_tails_stop_together(runs):
    assert [r['uneven'] for r in runs['pod']] == [[0, 1, 2], [0, 1, 2]]
    assert [r['global_all'] for r in runs['pod']] == [(True, False), (True, False)]


def test_pod_guard_refuses_what_the_jax_guard_refuses():
    """The construction-time errors of ``pod_guard.py:103-117``, word for
    word where JAX's are: an unknown ``on_abort``, an interval below 1, and
    an interval past 1 with collectives in the step."""
    from petastorm_tpu.parallel.pod_guard import PodSafeIterator as JaxGuard
    from petastorm_tpu_torch.parallel import PodSafeIterator
    for kwargs in ({'on_abort': 'ignore'}, {'consensus_interval': 0}):
        for guard in (PodSafeIterator, JaxGuard):
            with pytest.raises(ValueError):
                guard(iter(()), **kwargs)
    with pytest.raises(ValueError, match='deadlocks'):
        PodSafeIterator(iter(()), consensus_interval=2)
    assert list(PodSafeIterator(iter(range(5)), consensus_interval=2,
                                step_has_collectives=False)) == list(range(5))


def test_pod_guard_without_a_group_is_the_iterator():
    """One process, no group: the vote is the local flag, a local failure
    raises as it is and the end of data ends iteration."""
    from petastorm_tpu_torch.parallel import PodSafeIterator, global_all

    def failing():
        yield 1
        raise KeyError('local')

    assert global_all(True) and not global_all(False)
    guard = PodSafeIterator(failing())
    assert next(guard) == 1
    with pytest.raises(KeyError):
        next(guard)
    with pytest.raises(StopIteration):
        next(guard)
    assert list(PodSafeIterator(iter([3, 4]))) == [3, 4]
