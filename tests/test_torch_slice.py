"""The slice as a whole on the CPU: JAX reader + JaxLoader + flax ResNetTiny
against the port's reader + TorchLoader + ResNetTiny on one store.

The store is PNG, so both decoders give the same pixels and the batches
must be equal. Labels are compared by value: the JAX loader narrows int64
to int32, the port keeps int64. Three SGD steps follow, from the same
weights; their losses must agree at ``rtol=1e-3`` (f32 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu.jax_loader import JaxLoader
from petastorm_tpu.models.resnet import ResNetTiny as JaxResNetTiny
from petastorm_tpu.models.train import create_train_state as jax_create_train_state
from petastorm_tpu.models.train import make_train_step as jax_make_train_step
from petastorm_tpu.ops.image_ops import normalize_images as jax_normalize_images
from petastorm_tpu_torch import (CompressedImageCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, make_tensor_reader, write_dataset)
from petastorm_tpu_torch.convert import load_flax_resnet
from petastorm_tpu_torch.models import ResNetTiny, create_train_state, make_train_step
from petastorm_tpu_torch.ops.image_ops import normalize_images

BATCH, ROWS, PER_GROUP, SIZE = 8, 48, 12, 32


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    schema = Unischema('SliceSchema', [
        UnischemaField('image', np.uint8, (SIZE, SIZE, 3), CompressedImageCodec('png')),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64)),
    ])
    rng = np.random.default_rng(21)
    url = 'file://' + str(tmp_path_factory.mktemp('slice') / 'store')
    # 12-row groups under 8-row batches: every other batch spans two chunks.
    write_dataset(url, schema, ({'image': rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8),
                                 'label': int(rng.integers(0, 10))} for _ in range(ROWS)),
                  rows_per_row_group=PER_GROUP)
    return url


def _jax_batches(url):
    with jax_make_tensor_reader(url, reader_pool_type='thread', workers_count=1,
                                shuffle_row_groups=False) as reader:
        with JaxLoader(reader, BATCH, prefetch=2) as loader:
            return [(np.asarray(b.image), np.asarray(b.label)) for b in loader]


def _port_batches(url, device='cpu'):
    with make_tensor_reader(url, workers_count=1, shuffle_row_groups=False) as reader:
        with TorchLoader(reader, BATCH, device=device, prefetch=2) as loader:
            return [(b.image, b.label) for b in loader]


def test_batches_equal_jax_loader(store):
    theirs = _jax_batches(store)
    ours = _port_batches(store)
    assert len(ours) == len(theirs) == ROWS // BATCH
    for (image, label), (want_image, want_label) in zip(ours, theirs):
        assert image.dtype == torch.uint8 and label.dtype == torch.int64
        np.testing.assert_array_equal(image.numpy(), want_image)
        np.testing.assert_array_equal(label.numpy(), want_label.astype(np.int64))


def test_three_sgd_steps_match_flax(store):
    jax_model = JaxResNetTiny(num_classes=10, dtype=jnp.float32)
    jax_state = jax_create_train_state(jax.random.PRNGKey(0), jax_model, (1, SIZE, SIZE, 3),
                                       learning_rate=0.1)
    port_model = load_flax_resnet(
        ResNetTiny(num_classes=10, dtype=torch.float32, device='cpu'),
        {k: np.asarray(v) for k, v in flatten_dict(jax_state.params).items()},
        {k: np.asarray(v) for k, v in flatten_dict(jax_state.batch_stats).items()})
    port_state = create_train_state(port_model, learning_rate=0.1, momentum=0.9)
    jax_step, port_step = jax_make_train_step(), make_train_step()
    theirs, ours = [], []
    for (image, label), (want_image, want_label) in list(zip(_port_batches(store),
                                                             _jax_batches(store)))[:3]:
        jax_state, metrics = jax_step(jax_state, jax_normalize_images(want_image, dtype=jnp.float32),
                                      want_label)
        theirs.append(float(metrics['loss']))
        ours.append(float(port_step(port_state, normalize_images(image, dtype=torch.float32),
                                    label)['loss']))
    np.testing.assert_allclose(ours, theirs, rtol=1e-3)
    assert all(np.isfinite(ours))

