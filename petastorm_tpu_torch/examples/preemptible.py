"""Preemptible training: the whole job survives a kill mid-epoch.

Counterpart of ``examples/preemptible/train_resume_example.py``:

* the tensor reader streams decoded batches with exactly-once row
  accounting (``resume_state=``);
* a :class:`~petastorm_tpu_torch.job_checkpoint.JobCheckpointer` saves the
  model, the optimizer and the loader's row position as one atomic
  artifact every ``ckpt_every`` steps;
* ``run()`` simulates a preemption by tearing the whole pipeline down
  mid-epoch, then resumes from the latest checkpoint in a fresh state and
  pipeline: bit-exact parameters, no row lost (the final partial batch is
  dropped for static shapes), and only the rows delivered after the
  checkpoint seen twice.

    python -m petastorm_tpu_torch.examples.preemptible [--device cuda]
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from petastorm_tpu_torch import (NdarrayCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, make_tensor_reader, resolve_device, write_dataset)
from petastorm_tpu_torch.job_checkpoint import JobCheckpointer
from petastorm_tpu_torch.models import MLP, create_train_state, make_train_step
from petastorm_tpu_torch.models.transformer import init_flax_like

PreemptibleSchema = Unischema('Preemptible', [
    UnischemaField('x', np.float32, (8,), NdarrayCodec(), False),
    UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False),
    UnischemaField('sample_id', np.int64, (), ScalarCodec(np.int64), False),
])


def _build_pipeline(url, batch, device, resume_state=None):
    reader = make_tensor_reader(url, reader_pool_type='thread', workers_count=2, num_epochs=1,
                                seed=0, resume_state=resume_state)
    return reader, TorchLoader(reader, batch, device=device, last_batch='drop')


def _fresh_state(device):
    model = init_flax_like(MLP(8, features=(16, 4), device=device),
                           torch.Generator().manual_seed(0))
    return create_train_state(model)


def run(dataset_url=None, ckpt_dir=None, batch=16, preempt_after=3, ckpt_every=1, n_rows=128,
        device='cuda'):
    """Train, die mid-epoch, resume. Returns (losses, seen sample ids,
    restored step)."""
    device = resolve_device(device)
    if dataset_url is None:
        dataset_url = 'file://' + tempfile.mkdtemp(prefix='preemptible_ds_')
    if not os.path.exists(dataset_url.replace('file://', '', 1) + '/_common_metadata'):
        rng = np.random.default_rng(0)
        write_dataset(dataset_url, PreemptibleSchema,
                      ({'x': rng.standard_normal(8).astype(np.float32), 'label': i % 4,
                        'sample_id': i} for i in range(n_rows)),
                      rows_per_row_group=16)
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix='preemptible_ckpt_')
    train_step = make_train_step()
    losses, seen = [], []

    # Session 1: train until the "preemption".
    state = _fresh_state(device)
    with JobCheckpointer(ckpt_dir, max_to_keep=2) as ckpt:
        reader, loader = _build_pipeline(dataset_url, batch, device)
        with reader, loader:
            for step_i, b in enumerate(loader):
                losses.append(float(train_step(state, b.x, b.label)['loss']))
                seen.extend(b.sample_id.tolist())
                if step_i % ckpt_every == 0:
                    # The loader's position is taken with the parameters.
                    ckpt.save(step_i, state, loader=loader, extra={'epoch': 0})
                if step_i + 1 >= preempt_after:
                    break   # the preemption: the pipeline is torn down mid-epoch
    del state, reader, loader

    # Session 2: a fresh process would start exactly like this.
    with JobCheckpointer(ckpt_dir) as ckpt:
        job = ckpt.restore(_fresh_state(device))
    if job is None:
        raise RuntimeError('no checkpoint found to resume from in {}'.format(ckpt_dir))
    state = job.state
    reader, loader = _build_pipeline(dataset_url, batch, device, resume_state=job.loader_state)
    with reader, loader:
        for b in loader:
            losses.append(float(train_step(state, b.x, b.label)['loss']))
            seen.extend(b.sample_id.tolist())

    # Rows delivered after the checkpoint in session 1 were not recorded
    # consumed, so they re-deliver: exactly-once holds at the checkpoint.
    print('preemptible example: {} steps, resumed at step {}, {} distinct rows of {}'.format(
        len(losses), job.step, len(set(seen)), n_rows))
    return losses, seen, job.step


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--dataset-url', default=None)
    parser.add_argument('--ckpt-dir', default=None)
    parser.add_argument('--batch', type=int, default=16)
    parser.add_argument('--preempt-after', type=int, default=3)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    run(args.dataset_url, args.ckpt_dir, batch=args.batch, preempt_after=args.preempt_after,
        device=args.device)


if __name__ == '__main__':
    main()
