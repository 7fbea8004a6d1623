"""The port's examples end to end on the CPU, at the sizes of the JAX
package's example tests (``tests/test_examples.py``)."""

import math

import pytest

from petastorm_tpu_torch.examples import imagenet, long_context, mnist


def test_mnist_train_reaches_accuracy(tmp_path):
    pytest.importorskip('sklearn')
    url = 'file://' + str(tmp_path / 'mnist')
    mnist.generate_mnist_dataset(url)
    accuracy = mnist.train_and_test(url, epochs=3, batch_size=64, reader_pool_type='dummy',
                                    device='cpu')
    assert accuracy > 0.8, 'MLP failed to learn digits: accuracy {}'.format(accuracy)


@pytest.mark.parametrize('augment', [False, True])
def test_imagenet_one_step(tmp_path, augment):
    url = 'file://' + str(tmp_path / 'imagenet')
    imagenet.generate_synthetic(url, classes=2, images_per_class=8, height=40, width=40,
                                ragged=6, rows_per_row_group=5)
    state, losses = imagenet.train(url, batch_size=8, steps=1, image_size=32, log_every=1,
                                   augment=augment, device='cpu', workers_count=2)
    assert state.optimizer.state and len(losses) == 1 and math.isfinite(losses[0])


def test_long_context_four_steps(tmp_path):
    url = 'file://' + str(tmp_path / 'lm')
    long_context.generate(url, num_docs=24, seq_len=64, vocab_size=512, rows_per_row_group=8)
    model, losses = long_context.train(url, vocab_size=512, batch_size=4, steps=4, d_model=32,
                                       num_heads=2, num_layers=1, log_every=2, device='cpu')
    assert len(losses) == 4 and all(math.isfinite(v) for v in losses)
    assert model.max_len == 64 and model.blocks[0].attn.attention == 'flash'


@pytest.mark.timeout(200)
def test_imagenet_model_parallel_on_two_ranks(tmp_path):
    """``model_parallel=2`` on two gloo ranks: the head split over 'model',
    both ranks reading the same rows and reporting the same losses."""
    import torch_mesh_ranks
    from petastorm_tpu_torch.parallel.launch import spawn
    url = 'file://' + str(tmp_path / 'imagenet')
    imagenet.generate_synthetic(url, classes=2, images_per_class=8, height=40, width=40,
                                ragged=6, rows_per_row_group=5)
    results = spawn(torch_mesh_ranks.example_imagenet_model_parallel, 2, (url,), timeout=150)
    (losses, placements), (other, _) = results
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses) and losses == other
    assert placements == {'head.weight': ('model', None), 'head.bias': ('model',)}


@pytest.mark.timeout(200)
def test_long_context_ring_attention_over_sp(tmp_path):
    """``seq_parallel=2`` on two gloo ranks: ring attention over 'sp', each
    rank holding half of the sequence, the same global losses on both."""
    import torch_mesh_ranks
    from petastorm_tpu_torch.parallel.launch import spawn
    url = 'file://' + str(tmp_path / 'lm')
    long_context.generate(url, num_docs=24, seq_len=64, vocab_size=512, rows_per_row_group=4)
    results = spawn(torch_mesh_ranks.example_long_context_seq_parallel, 2, (url,), timeout=150)
    (losses, attention), (other, _) = results
    assert attention == 'ring' and len(losses) == 4 and losses == other
    assert all(math.isfinite(v) for v in losses)
