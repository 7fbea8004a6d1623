"""Train a TransformerLM with flash attention (the hand-written Hopper
kernels on the card) on a token store through the port. Counterpart of
``examples/long_context/train_lm_example.py`` and
``generate_lm_dataset.py``. On one GPU a card holds the whole sequence;
with ``seq_parallel`` the model runs ring attention over an ``'sp'`` axis
of a ``{'data': world / sp, 'sp': sp}`` mesh, one process a GPU, each rank
holding ``T / sp`` of the sequence (as the JAX example does).

    python -m petastorm_tpu_torch.examples.long_context --generate
    torchrun --nproc-per-node=4 -m petastorm_tpu_torch.examples.long_context --seq-parallel 4
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from petastorm_tpu_torch import (NdarrayCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, make_tensor_reader, resolve_device,
                                 write_dataset)
from petastorm_tpu_torch.models import TransformerLM
from petastorm_tpu_torch.models.train import create_train_state, make_lm_train_step
from petastorm_tpu_torch.models.transformer import init_flax_like


def lm_schema(seq_len):
    return Unischema('LongContextLM', [
        UnischemaField('doc_id', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('tokens', np.int32, (seq_len,), NdarrayCodec(), False),
    ])


def generate(url, num_docs=256, seq_len=2048, vocab_size=32000, seed=0, rows_per_row_group=32):
    """Synthetic token streams, each drawn from a small per-document
    vocabulary, so that a small model learns them in a few steps."""
    rng = np.random.default_rng(seed)

    def rows():
        for i in range(num_docs):
            base = rng.integers(0, vocab_size - 64)
            yield {'doc_id': i, 'tokens': (base + rng.integers(0, 64, seq_len)).astype(np.int32)}

    write_dataset(url, lm_schema(seq_len), rows(), rows_per_row_group=rows_per_row_group)
    return url


def _adamw(params):
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def train(dataset_url, vocab_size=32000, batch_size=8, steps=20, d_model=256, num_heads=4,
          num_layers=2, log_every=5, device='cuda', seq_parallel=None):
    """``steps`` AdamW steps (lr 3e-4, optax's defaults) of next-token cross
    entropy over the rolled targets; bf16 on the card, f32 on the CPU.
    Returns ``(model, losses)``. ``seq_parallel`` (on every rank of a
    started process group): ring attention over the mesh of the module
    docstring, ``batch_size`` the global batch."""
    device = resolve_device(device)
    if seq_parallel is not None:
        return _train_sequence_parallel(dataset_url, vocab_size, batch_size, steps, d_model,
                                        num_heads, num_layers, log_every, device, seq_parallel)
    dtype = torch.bfloat16 if device.type == 'cuda' else torch.float32
    model = None
    losses = []
    with make_tensor_reader(dataset_url, schema_fields=['tokens'], num_epochs=None,
                            workers_count=4, cache_type='memory', shuffle_row_groups=True,
                            seed=0) as reader:
        seq_len = reader.schema.fields['tokens'].shape[0]
        model = init_flax_like(
            TransformerLM(vocab_size, d_model, num_heads, num_layers, max_len=seq_len,
                          attention='flash', dtype=dtype, device=device),
            torch.Generator().manual_seed(0))
        optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=1e-4)
        with TorchLoader(reader, batch_size, device=device) as loader:
            for step, batch in enumerate(loader, 1):
                tokens = batch.tokens
                logits = model(tokens)
                targets = torch.roll(tokens, -1, dims=1).long()
                loss = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                       targets[:, :-1].reshape(-1))
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                optimizer.step()
                losses.append(float(loss.detach()))
                if step % log_every == 0:
                    print('step {}: loss {:.4f}'.format(step, losses[-1]))
                if step >= steps:
                    break
    return model, losses


def _train_sequence_parallel(dataset_url, vocab_size, batch_size, steps, d_model, num_heads,
                             num_layers, log_every, device, sp):
    import torch.distributed as dist
    from petastorm_tpu_torch import make_pod_reader
    from petastorm_tpu_torch.parallel import make_mesh, sequence_sharding
    dtype = torch.bfloat16 if device.type == 'cuda' else torch.float32
    mesh = make_mesh({'data': dist.get_world_size() // sp, 'sp': sp}, device=device.type)
    losses = []
    with make_pod_reader(dataset_url, mesh=mesh, schema_fields=['tokens'], num_epochs=None,
                         workers_count=4, cache_type='memory', shuffle_row_groups=True,
                         seed=0, deterministic=True) as reader:
        seq_len = reader.schema.fields['tokens'].shape[0]
        model = init_flax_like(
            TransformerLM(vocab_size, d_model, num_heads, num_layers, max_len=seq_len,
                          attention='ring', dtype=dtype, device=device, mesh=mesh,
                          seq_axis='sp'),
            torch.Generator().manual_seed(0))
        state = create_train_state(model, mesh=mesh, make_optimizer=_adamw)
        step_fn = make_lm_train_step(mesh=mesh)
        with TorchLoader(reader, batch_size, mesh=mesh, sharding={
                'tokens': sequence_sharding(mesh, seq_axis='sp')}) as loader:
            for step, batch in enumerate(loader, 1):
                losses.append(float(step_fn(state, batch.tokens)['loss']))
                if step % log_every == 0 and dist.get_rank() == 0:
                    print('step {}: loss {:.4f}'.format(step, losses[-1]))
                if step >= steps:
                    break
    return model, losses


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--dataset-url', default='file:///tmp/lm_dataset_torch')
    parser.add_argument('--generate', action='store_true', help='write the store first')
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--seq-parallel', type=int, default=None,
                        help="ring attention over an 'sp' axis of this size (run under "
                             'torchrun: one process a GPU, the batch global)')
    args = parser.parse_args()
    if args.seq_parallel is None:
        if args.generate:
            generate(args.dataset_url)
        train(args.dataset_url, batch_size=args.batch_size, steps=args.steps, device=args.device)
    else:
        from petastorm_tpu_torch.parallel.launch import init_from_env
        with init_from_env(args.device) as device:
            train(args.dataset_url, batch_size=args.batch_size, steps=args.steps, device=device,
                  seq_parallel=args.seq_parallel)
