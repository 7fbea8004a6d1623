"""The LM slice as a whole on the CPU: token Parquet -> tensor reader ->
loader -> TransformerLM SGD steps, JAX package against the port.

The store has the bench's LM schema (``bench.py:130-157``: one int32
``NdarrayCodec`` field ``tokens`` of shape ``(seq,)``, uniform tokens from
``np.random.default_rng(11)``), cut to 48 rows of 17 tokens in 12-row
groups under 8-row batches. Batches must be bit-identical (per-field CRC32,
``lineage._digest_array``). Three SGD steps follow from the same weights
(the bench's step body against ``make_lm_train_step``, f32, JAX dense
attention against the port's flash path); their losses must agree at
``rtol=1e-5``: both are f32 and differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu.codecs import NdarrayCodec as JaxNdarrayCodec
from petastorm_tpu.etl.dataset_metadata import get_schema_from_dataset_url
from petastorm_tpu.etl.writer import write_dataset as jax_write_dataset
from petastorm_tpu.jax_loader import JaxLoader
from petastorm_tpu.lineage import _digest_array
from petastorm_tpu.models import TransformerLM as JaxTransformerLM
from petastorm_tpu.unischema import Unischema as JaxUnischema, UnischemaField as JaxField
from petastorm_tpu_torch import (NdarrayCodec, TorchLoader, Unischema, UnischemaField,
                                 make_tensor_reader, write_dataset)
from petastorm_tpu_torch.convert import load_flax_transformer
from petastorm_tpu_torch.models import TransformerLM, create_train_state, make_lm_train_step

VOCAB, SEQ, ROWS, PER_GROUP, BATCH = 64, 17, 48, 12, 8


def _token_rows():
    rng = np.random.default_rng(11)
    return [{'tokens': rng.integers(0, VOCAB, SEQ, dtype=np.int32)} for _ in range(ROWS)]


@pytest.fixture(scope='module')
def jax_store(tmp_path_factory):
    schema = JaxUnischema('LMBenchSchema', [
        JaxField('tokens', np.int32, (SEQ,), JaxNdarrayCodec(), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('lm') / 'store')
    jax_write_dataset(url, schema, _token_rows(), rows_per_row_group=PER_GROUP)
    return url


def _jax_batches(url):
    with jax_make_tensor_reader(url, reader_pool_type='thread', workers_count=1,
                                shuffle_row_groups=False) as reader:
        with JaxLoader(reader, BATCH, prefetch=2) as loader:
            return [np.asarray(b.tokens) for b in loader]


def _port_batches(url):
    with make_tensor_reader(url, workers_count=1, shuffle_row_groups=False) as reader:
        with TorchLoader(reader, BATCH, device='cpu', prefetch=2) as loader:
            return [b.tokens for b in loader]


def test_token_batches_equal_jax_loader(jax_store):
    theirs = _jax_batches(jax_store)
    ours = _port_batches(jax_store)
    assert len(ours) == len(theirs) == ROWS // BATCH
    for got, want in zip(ours, theirs):
        assert got.dtype == torch.int32 and tuple(got.shape) == (BATCH, SEQ)
        assert _digest_array(got.numpy()) == _digest_array(want)


def test_port_writer_writes_the_bench_store(tmp_path):
    schema = Unischema('LMBenchSchema', [
        UnischemaField('tokens', np.int32, (SEQ,), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path / 'store')
    write_dataset(url, schema, _token_rows(), rows_per_row_group=PER_GROUP)
    field = get_schema_from_dataset_url(url).fields['tokens']
    assert (field.numpy_dtype, field.shape, field.nullable) == (np.int32, (SEQ,), False)
    assert isinstance(field.codec, JaxNdarrayCodec)
    want = np.stack([row['tokens'] for row in _token_rows()])
    got = np.concatenate(_jax_batches(url))
    assert _digest_array(got) == _digest_array(want)


def test_three_sgd_steps_match_the_bench_step(jax_store):
    jax_model = JaxTransformerLM(vocab_size=VOCAB, d_model=32, num_heads=4, num_layers=2,
                                 max_len=SEQ - 1, attention='dense', dtype=jnp.float32)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ - 1), jnp.int32))['params']
    port = load_flax_transformer(
        TransformerLM(VOCAB, 32, 4, 2, SEQ - 1, attention='flash', dtype=torch.float32,
                      device='cpu'),
        {k: np.asarray(v) for k, v in flatten_dict(params).items()})
    tx = optax.sgd(0.01, momentum=0.9)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state, tokens):
        x, y = tokens[:, :-1], tokens[:, 1:]

        def loss_fn(p):
            return optax.softmax_cross_entropy_with_integer_labels(
                jax_model.apply({'params': p}, x), y).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    state = create_train_state(port, learning_rate=0.01, momentum=0.9)
    port_step = make_lm_train_step()
    theirs, ours = [], []
    for got, want in list(zip(_port_batches(jax_store), _jax_batches(jax_store)))[:3]:
        params, opt_state, loss = jax_step(params, opt_state, jnp.asarray(want))
        theirs.append(float(loss))
        ours.append(float(port_step(state, got)['loss']))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)
    assert all(np.isfinite(ours)) and ours[-1] < ours[0]
