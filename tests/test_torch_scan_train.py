"""The port's scan trainers and eval step held against the JAX package's,
on the CPU, where the K-step body runs eagerly (the CUDA graph of it is
held against the eager body on the card, in ``tests/test_torch_cuda.py``).

Weights come from the flax models through ``petastorm_tpu_torch.convert``;
inputs from numpy with a seed. Tolerances are those of
``tests/test_torch_resnet.py::test_sgd_steps_match_flax``: loss, params and
batch stats ``rtol=1e-4`` (``atol=1e-5`` for params near zero), f32 on both
sides, 64x64 inputs and microbatches of 8 (a smaller last stage lets the
two BatchNorm variance formulas drift apart). The LM's losses agree at
``rtol=1e-5``, as in ``tests/test_torch_lm_slice.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from petastorm_tpu.models import TransformerLM as JaxTransformerLM
from petastorm_tpu.models import resnet as jax_resnet
from petastorm_tpu.models.train import TrainState
from petastorm_tpu.models.train import make_eval_step as jax_make_eval_step
from petastorm_tpu.models.train import make_scan_train_step as jax_make_scan_train_step
from petastorm_tpu.ops.image_ops import normalize_images as jax_normalize_images
from petastorm_tpu_torch.convert import load_flax_resnet, load_flax_transformer, resnet_params_from_flax
from petastorm_tpu_torch.models import (ResNetTiny, TransformerLM, create_train_state,
                                        make_eval_step, make_lm_scan_train_step,
                                        make_scan_train_step, make_train_step)
from petastorm_tpu_torch.models import train
from petastorm_tpu_torch.ops.image_ops import normalize_images

K, MICRO, SIZE, CLASSES = 4, 8, 64, 10


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree).items()}


def _resnets(seed):
    """The flax ResNetTiny with jittered variables, and the port's with the same."""
    jax_model = jax_resnet.ResNetTiny(num_classes=CLASSES, dtype=jnp.float32)
    x = np.zeros((1, SIZE, SIZE, 3), np.float32)
    variables = jax_model.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    rng = np.random.default_rng(seed)

    def jitter(path, leaf):
        leaf = np.asarray(leaf)
        if getattr(path[-1], 'key', None) == 'var':
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32))
        return jnp.asarray(leaf + rng.normal(0.0, 0.1, leaf.shape).astype(np.float32))

    variables = {col: jax.tree_util.tree_map_with_path(jitter, tree)
                 for col, tree in variables.items()}
    port = ResNetTiny(num_classes=CLASSES, dtype=torch.float32, device='cpu')
    load_flax_resnet(port, _flat(variables['params']), _flat(variables['batch_stats']))
    return jax_model, variables, port


def _superbatch(seed, n=K * MICRO):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8),
            rng.integers(0, CLASSES, n).astype(np.int64))


def _port_preprocess(images):
    return normalize_images(images, dtype=torch.float32)


def _jax_preprocess(images):
    return jax_normalize_images(images, dtype=jnp.float32)


def _assert_state_matches(port_model, params, batch_stats):
    want = resnet_params_from_flax(_flat(params), _flat(batch_stats))
    got = port_model.state_dict()
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_scan_train_step_matches_jax():
    jax_model, variables, port = _resnets(seed=3)
    jax_state = TrainState.create(apply_fn=jax_model.apply, params=variables['params'],
                                  tx=optax.sgd(0.1, momentum=0.9),
                                  batch_stats=variables['batch_stats'])
    jax_step = jax_make_scan_train_step(microbatches=K, preprocess=_jax_preprocess)
    state = create_train_state(port, learning_rate=0.1, momentum=0.9)
    step = make_scan_train_step(microbatches=K, preprocess=_port_preprocess)
    for call in range(2):
        images, labels = _superbatch(10 + call)
        jax_state, want = jax_step(jax_state, jnp.asarray(images), jnp.asarray(labels))
        got = step(state, torch.from_numpy(images), torch.from_numpy(labels))
        for name in ('loss', 'last_loss'):
            np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-4, err_msg=name)
        assert float(got['accuracy']) == pytest.approx(float(want['accuracy']))
        _assert_state_matches(port, jax_state.params, jax_state.batch_stats)
    assert state.step == 2 * K


def test_scan_equals_k_sequential_steps_exactly():
    _, _, scanned = _resnets(seed=5)
    _, _, stepped = _resnets(seed=5)
    scan_state = create_train_state(scanned, learning_rate=0.1, momentum=0.9)
    step_state = create_train_state(stepped, learning_rate=0.1, momentum=0.9)
    scan, single = make_scan_train_step(microbatches=K, preprocess=_port_preprocess), make_train_step()
    images, labels = (torch.from_numpy(a) for a in _superbatch(7))
    got = scan(scan_state, images, labels)
    losses, accs = [], []
    for i in range(K):
        part = slice(i * MICRO, (i + 1) * MICRO)
        m = single(step_state, _port_preprocess(images[part]), labels[part])
        losses.append(m['loss'])
        accs.append(m['accuracy'])
    assert torch.equal(got['loss'], torch.stack(losses).mean())
    assert torch.equal(got['accuracy'], torch.stack(accs).mean())
    assert torch.equal(got['last_loss'], losses[-1])
    for (name, a), (_, b) in zip(scanned.state_dict().items(), stepped.state_dict().items()):
        assert torch.equal(a, b), name
    assert scan_state.step == step_state.step == K


def test_superbatch_k_does_not_divide_raises():
    _, _, port = _resnets(seed=1)
    state = create_train_state(port)
    images, labels = (torch.from_numpy(a) for a in _superbatch(2, n=K * MICRO - 2))
    with pytest.raises(ValueError, match='not divisible'):
        make_scan_train_step(microbatches=K)(state, images, labels)
    with pytest.raises(ValueError, match='microbatches'):
        make_scan_train_step(microbatches=0)
    assert state.step == 0


def test_optimizer_view_sees_what_a_graph_holds_fixed():
    """A captured step replays its optimizer's hyperparameters and buffer
    addresses; the view it checks before each replay must change when
    either does, and only then."""
    model = torch.nn.Linear(4, 3)
    state = create_train_state(model, learning_rate=0.1, momentum=0.9)
    model(torch.ones(2, 4)).sum().backward()
    state.optimizer.step()                             # creates the momentum buffers
    view = train._optimizer_view(state.optimizer)
    assert train._optimizer_view(state.optimizer) == view
    state.optimizer.param_groups[0]['lr'] = 0.05
    assert train._optimizer_view(state.optimizer) != view
    state.optimizer.param_groups[0]['lr'] = 0.1
    state.optimizer.load_state_dict(state.optimizer.state_dict())   # the same buffers
    assert train._optimizer_view(state.optimizer) == view
    state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    assert train._optimizer_view(state.optimizer) != view


def test_eval_step_matches_jax():
    jax_model, variables, port = _resnets(seed=8)
    jax_state = TrainState.create(apply_fn=jax_model.apply, params=variables['params'],
                                  tx=optax.sgd(0.1), batch_stats=variables['batch_stats'])
    images, labels = _superbatch(9, n=MICRO)
    x = images.astype(np.float32) / 255.0
    want = jax_make_eval_step()(jax_state, jnp.asarray(x), jnp.asarray(labels))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got = make_eval_step()(create_train_state(port), torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got['loss']), float(want['loss']), rtol=1e-4)
    assert float(got['accuracy']) == pytest.approx(float(want['accuracy']))
    for name, value in port.state_dict().items():     # eval moves no running statistic
        assert torch.equal(value, before[name]), name


def test_lm_scan_train_step_matches_the_bench_scan():
    vocab, seq, batch, k = 64, 17, 4, 2
    jax_model = JaxTransformerLM(vocab_size=vocab, d_model=32, num_heads=4, num_layers=2,
                                 max_len=seq - 1, attention='dense', dtype=jnp.float32)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, seq - 1), jnp.int32))['params']
    port = load_flax_transformer(
        TransformerLM(vocab, 32, 4, 2, seq - 1, attention='flash', dtype=torch.float32,
                      device='cpu'), _flat(params))
    tx = optax.sgd(0.01, momentum=0.9)
    opt_state = tx.init(params)

    @jax.jit
    def train_scan(params, opt_state, tokens_k):      # bench.py:216-244, non-MoE
        def body(carry, tokens):
            params, opt_state = carry
            x, y = tokens[:, :-1], tokens[:, 1:]

            def loss_fn(p):
                return optax.softmax_cross_entropy_with_integer_labels(
                    jax_model.apply({'params': p}, x), y).mean()

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state), loss

        (params, opt_state), losses = jax.lax.scan(body, (params, opt_state), tokens_k)
        return params, opt_state, losses

    state = create_train_state(port, learning_rate=0.01, momentum=0.9)
    step = make_lm_scan_train_step(microbatches=k)
    tokens = np.random.default_rng(11).integers(0, vocab, (k * batch, seq), dtype=np.int32)
    ours, theirs = [], []
    for _ in range(2):                                 # the same superbatch twice
        params, opt_state, losses = train_scan(params, opt_state,
                                               jnp.asarray(tokens).reshape(k, batch, seq))
        theirs.extend(np.asarray(losses).tolist())
        got = step(state, torch.from_numpy(tokens))['losses']
        assert tuple(got.shape) == (k,)
        ours.extend(got.tolist())
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)
    assert all(np.isfinite(ours)) and ours[k] < ours[0] and ours[k + 1] < ours[1]
    assert state.step == 2 * k
