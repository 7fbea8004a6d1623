"""Train an MLP on an MNIST-style store through the port: the per-row
reader, a row-level shuffling buffer reseeded each epoch, and a test pass
that keeps the last partial batch. Counterpart of
``examples/mnist/jax_example.py`` and ``generate_mnist_dataset.py``.

    python -m petastorm_tpu_torch.examples.mnist --generate [--dataset-url URL]

The store is scikit-learn's bundled 8x8 digits (no download), split 80/20
into ``<url>/train`` and ``<url>/test``, 200-row groups.
"""

import argparse

import numpy as np
import torch

from petastorm_tpu_torch import (NdarrayCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, make_reader, resolve_device, write_dataset)
from petastorm_tpu_torch.models import MLP, create_train_state, make_eval_step, make_train_step
from petastorm_tpu_torch.models.transformer import init_flax_like

MnistSchema = Unischema('MnistSchema', [
    UnischemaField('idx', np.int64, (), ScalarCodec(np.int64), False),
    UnischemaField('digit', np.int64, (), ScalarCodec(np.int64), False),
    UnischemaField('image', np.uint8, (8, 8), NdarrayCodec(), False),
])


def generate_mnist_dataset(output_url, train_fraction=0.8):
    """Write the digits as ``<output_url>/train`` and ``<output_url>/test``."""
    from sklearn.datasets import load_digits

    digits = load_digits()
    images = digits.images.astype(np.uint8)
    labels = digits.target.astype(np.int64)
    split = int(len(images) * train_fraction)
    for name, lo, hi in (('train', 0, split), ('test', split, len(images))):
        url = output_url.rstrip('/') + '/' + name
        write_dataset(url, MnistSchema, ({'idx': i, 'digit': labels[i], 'image': images[i]}
                                         for i in range(lo, hi)), rows_per_row_group=200)
        print('Wrote {} rows to {}'.format(hi - lo, url))


def train_and_test(dataset_url, epochs=5, batch_size=64, learning_rate=0.05,
                   reader_pool_type='thread', device='cuda'):
    """SGD (momentum 0.9) on ``MLP(features=(128, 64))``; returns the test
    accuracy."""
    device = resolve_device(device)
    model = init_flax_like(MLP(64, features=(128, 64), num_classes=10, device=device),
                           torch.Generator().manual_seed(0))
    state = create_train_state(model, learning_rate=learning_rate)
    train_step, eval_step = make_train_step(), make_eval_step()

    for epoch in range(epochs):
        with make_reader(dataset_url + '/train', num_epochs=1, seed=epoch, shuffle_row_groups=True,
                         reader_pool_type=reader_pool_type) as reader:
            with TorchLoader(reader, batch_size, device=device, shuffling_queue_capacity=500,
                             seed=epoch) as loader:
                losses = [train_step(state, batch.image.float() / 16.0, batch.digit)['loss']
                          for batch in loader]
        print('epoch {}: train loss {:.4f}'.format(epoch, float(torch.stack(losses).mean())))

    with make_reader(dataset_url + '/test', num_epochs=1, reader_pool_type=reader_pool_type) as reader:
        with TorchLoader(reader, batch_size, device=device, last_batch='partial') as loader:
            accs = [(float(eval_step(state, batch.image.float() / 16.0, batch.digit)['accuracy']),
                     len(batch.digit)) for batch in loader]
    accuracy = sum(a * n for a, n in accs) / sum(n for _, n in accs)
    print('test accuracy: {:.4f}'.format(accuracy))
    return accuracy


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--dataset-url', default='file:///tmp/mnist_dataset_torch')
    parser.add_argument('--generate', action='store_true', help='write the store first')
    parser.add_argument('--epochs', type=int, default=5)
    parser.add_argument('--batch-size', type=int, default=64)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    if args.generate:
        generate_mnist_dataset(args.dataset_url)
    train_and_test(args.dataset_url, args.epochs, args.batch_size, device=args.device)
