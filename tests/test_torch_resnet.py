"""The port's ResNet and SGD step held against the flax model, weights
carried across by ``petastorm_tpu_torch.convert``.

Both sides run in f32 on the CPU. Tolerances: logits ``rtol=1e-4,
atol=1e-5``; loss, updated params and batch stats ``rtol=1e-4`` (with a
``1e-5`` floor for values near zero): f32 convolutions and the two
BatchNorm variance formulas round differently.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from petastorm_tpu.models import resnet as jax_resnet
from petastorm_tpu.models.train import TrainState, make_train_step as jax_make_train_step
from petastorm_tpu_torch.convert import load_flax_resnet, resnet_params_from_flax
from petastorm_tpu_torch.models import resnet as port_resnet
from petastorm_tpu_torch.models.train import create_train_state, make_train_step

ARCHS = {
    'tiny': (jax_resnet.ResNetTiny, port_resnet.ResNetTiny, {}),
    'bottleneck': (jax_resnet.ResNet, port_resnet.ResNet,
                   {'stage_sizes': [1, 1, 1, 1], 'num_filters': 8}),
}


def _models(arch, stem):
    jax_cls, port_cls, kwargs = ARCHS[arch]
    jax_kwargs, port_kwargs = dict(kwargs), dict(kwargs)
    if arch == 'bottleneck':
        jax_kwargs['block_cls'] = jax_resnet.BottleneckBlock
        port_kwargs['block_cls'] = port_resnet.BottleneckBlock
    jax_model = jax_cls(num_classes=10, stem=stem, dtype=jnp.float32, **jax_kwargs)
    port_model = port_cls(num_classes=10, stem=stem, dtype=torch.float32, device='cpu',
                          **port_kwargs)
    return jax_model, port_model


def _perturbed_variables(jax_model, x, seed):
    """Init, then jitter every param and stat so zero-initialised scales
    and unit running stats cannot hide a layout or convention bug."""
    variables = jax_model.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    rng = np.random.default_rng(seed)

    def jitter(path, leaf):
        leaf = np.asarray(leaf)
        if path[-1] == 'var':
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32))
        return jnp.asarray(leaf + rng.normal(0.0, 0.1, leaf.shape).astype(np.float32))

    return {col: jax.tree_util.tree_map_with_path(
        lambda p, leaf: jitter(tuple(getattr(k, 'key', k) for k in p), leaf), tree)
        for col, tree in variables.items()}


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree).items()}


def _inputs(seed, n=4, size=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(0.0, 1.0, (n, size, size, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int64))


def _assert_state_matches(port_model, params, batch_stats):
    want = resnet_params_from_flax(_flat(params), _flat(batch_stats))
    got = port_model.state_dict()
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize('arch', sorted(ARCHS))
@pytest.mark.parametrize('stem', ['conv7', 'space_to_depth'])
def test_forward_matches_flax(arch, stem):
    jax_model, port_model = _models(arch, stem)
    x, _ = _inputs(0)
    variables = _perturbed_variables(jax_model, x, seed=1)
    load_flax_resnet(port_model, _flat(variables['params']), _flat(variables['batch_stats']))

    want = jax_model.apply(variables, jnp.asarray(x), train=False)
    port_model.eval()
    got = port_model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    want, updates = jax_model.apply(variables, jnp.asarray(x), train=True,
                                    mutable=['batch_stats'])
    port_model.train()
    got = port_model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    _assert_state_matches(port_model, variables['params'], updates['batch_stats'])


@pytest.mark.parametrize('arch', sorted(ARCHS))
@pytest.mark.parametrize('stem', ['conv7', 'space_to_depth'])
def test_sgd_steps_match_flax(arch, stem):
    """Two momentum-SGD steps: loss, params and batch stats after each."""
    jax_model, port_model = _models(arch, stem)
    x, labels = _inputs(2, n=8, size=64)
    variables = _perturbed_variables(jax_model, x, seed=3)
    load_flax_resnet(port_model, _flat(variables['params']), _flat(variables['batch_stats']))
    jax_state = TrainState.create(apply_fn=jax_model.apply, params=variables['params'],
                                  tx=optax.sgd(0.1, momentum=0.9),
                                  batch_stats=variables['batch_stats'])
    jax_step = jax_make_train_step()
    port_state = create_train_state(port_model, learning_rate=0.1, momentum=0.9)
    port_step = make_train_step()
    for i in range(2):
        xi = x[::-1].copy() if i else x
        jax_state, jax_metrics = jax_step(jax_state, jnp.asarray(xi), jnp.asarray(labels))
        metrics = port_step(port_state, torch.from_numpy(xi), torch.from_numpy(labels))
        np.testing.assert_allclose(float(metrics['loss']), float(jax_metrics['loss']), rtol=1e-4)
        assert float(metrics['accuracy']) == pytest.approx(float(jax_metrics['accuracy']))
        _assert_state_matches(port_model, jax_state.params, jax_state.batch_stats)


def test_same_padding_hazards_match_flax():
    """Flax 'SAME' pads (0, 1) for a 3x3/2 conv and the 3x3/2 max pool on an
    even input, and (1, 2) for the 4x4/1 conv: the port pads explicitly."""
    assert port_resnet.same_padding(16, 3, 2) == (0, 1)
    assert port_resnet.same_padding(15, 3, 2) == (1, 1)
    assert port_resnet.same_padding(16, 4, 1) == (1, 2)
    assert port_resnet.same_padding(16, 1, 2) == (0, 0)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 16, 5)).astype(np.float32)
    for kernel, stride in ((3, 2), (4, 1), (3, 1)):
        conv = nn.Conv(6, (kernel, kernel), strides=(stride, stride), use_bias=False)
        params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = conv.apply(params, jnp.asarray(x))
        port = port_resnet.Conv(5, 6, kernel, stride=stride)
        port.weight.data = torch.from_numpy(
            np.asarray(params['params']['kernel']).transpose(3, 2, 0, 1).copy())
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want = nn.max_pool(jnp.asarray(x) - 10.0, (3, 3), strides=(2, 2), padding='SAME')
    got = torch.nn.functional.max_pool2d(
        port_resnet._pad_same(torch.from_numpy(x - 10.0).permute(0, 3, 1, 2), 3, 2,
                              value=-float('inf')), 3, stride=2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batchnorm_running_var_uses_biased_variance():
    """Flax folds the biased batch variance into ``var`` with momentum 0.9."""
    rng = np.random.default_rng(5)
    x = rng.normal(2.0, 3.0, (4, 3, 3, 7)).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, updates = bn.apply(variables, jnp.asarray(x), mutable=['batch_stats'])
    port = port_resnet.BatchNorm(7).train()
    port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(updates['batch_stats']['var']), rtol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(updates['batch_stats']['mean']), rtol=1e-5, atol=1e-7)


def test_init_flax_like_zero_scales_and_is_seeded():
    a = port_resnet.init_flax_like(port_resnet.ResNetTiny(num_classes=10, device='cpu'),
                                   torch.Generator().manual_seed(0))
    b = port_resnet.init_flax_like(port_resnet.ResNetTiny(num_classes=10, device='cpu'),
                                   torch.Generator().manual_seed(0))
    for (name, pa), (_, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(pa, pb), name
    assert float(a.blocks[0].norm1.weight.detach().abs().sum()) == 0.0   # last BN of the block
    assert float(a.bn_init.weight.detach().min()) == 1.0
    w = a.head.weight.detach()
    assert float(w.abs().max()) <= 2 * (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978 + 1e-6
