"""Decode in server processes, train on the card, and survive the death of
either tier mid-epoch (counterpart of
``examples/data_service/serve_and_train.py``).

    python -m petastorm_tpu_torch.examples.serve_and_train [--demo crash] [--device cpu]

``--demo checkpoint`` (the default): two
:class:`~petastorm_tpu_torch.data_service.DataServer` s decode the store, a
shard each, and one trainer pulls the merged stream through
:class:`~petastorm_tpu_torch.data_service.RemoteReader` ->
:class:`~petastorm_tpu_torch.loader.TorchLoader` -> the port's MLP.
Mid-epoch the trainer takes ``loader.state_dict()`` (the servers pause at a
chunk boundary, the chunks in flight drain into the state, rows still in
the loader's prefetch stay accounted), then servers and trainer are torn
down; fresh servers start from ``state['server_states'][i]`` and a fresh
trainer from ``resume_state=state``. Together they deliver exactly the rows
the first session had not consumed.

``--demo crash``: two server processes (``python -m`` this module with
``--_serve``, no torch imported, ``CUDA_VISIBLE_DEVICES=''``) snapshot
themselves every 2 chunks; one is SIGKILLed mid-stream and restarted from
its snapshot on the same endpoint. The trainer is never restarted: it drops
the replayed chunks by ``(server_id, seq)`` and finishes the epoch with
every row of each server delivered exactly once.

Endpoints are ``ipc://`` sockets in a temporary directory, so the example
takes no TCP port.
"""

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np


def _write_store(url, n_rows):
    from petastorm_tpu_torch import NdarrayCodec, ScalarCodec, Unischema, UnischemaField
    from petastorm_tpu_torch import write_dataset

    rng = np.random.default_rng(0)
    schema = Unischema('SvcExample', [
        UnischemaField('x', np.float32, (8,), NdarrayCodec(), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('sample_id', np.int64, (), ScalarCodec(np.int64), False),
    ])
    write_dataset(url, schema, ({'x': rng.standard_normal(8).astype(np.float32),
                                 'label': int(i % 4), 'sample_id': i} for i in range(n_rows)),
                  rows_per_row_group=8)


def _start_servers(url, sockets, states=None):
    """The decode tier: one server a shard of the store."""
    from petastorm_tpu_torch.data_service import serve_dataset

    return [serve_dataset(url, 'ipc://{}'.format(os.path.join(sockets, 'server{}'.format(i))),
                          num_epochs=1, seed=0, workers_count=1, cur_shard=i,
                          shard_count=len(states or [None, None]),
                          resume_state=None if states is None else states[i])
            for i in range(len(states or [None, None]))]


def _trainer(device):
    import torch

    from petastorm_tpu_torch import resolve_device
    from petastorm_tpu_torch.models import MLP, create_train_state, make_train_step
    from petastorm_tpu_torch.models.transformer import init_flax_like

    device = resolve_device(device)
    model = init_flax_like(MLP(8, features=(16,), num_classes=4, device=device),
                           torch.Generator().manual_seed(0))
    return create_train_state(model, learning_rate=0.05), make_train_step()


def run(dataset_url=None, batch=8, n_rows=96, preempt_after=3, device='cuda'):
    """Serve + train + checkpoint + tear down both tiers + resume. Returns
    ``(losses, seen_ids, pending_chunks_in_state)``."""
    from petastorm_tpu_torch import TorchLoader
    from petastorm_tpu_torch.data_service import RemoteReader

    url = dataset_url or 'file://' + tempfile.mkdtemp(prefix='pstt-svc-example-')
    if not os.path.exists(url.replace('file://', '', 1) + '/_common_metadata'):
        _write_store(url, n_rows)
    sockets = tempfile.mkdtemp(prefix='pstt-svc-sockets-')
    state, train_step = _trainer(device)
    losses, seen = [], []

    def train(loader, stop_after=None):
        for step, b in enumerate(loader):
            losses.append(float(train_step(state, b.x, b.label)['loss']))
            seen.extend(b.sample_id.tolist())
            if stop_after is not None and step + 1 >= stop_after:
                return loader.state_dict()
        return None

    # Session 1: both tiers, checkpointed mid-epoch, then torn down.
    servers = _start_servers(url, sockets)
    reader = RemoteReader([s.data_endpoint for s in servers])
    try:
        with TorchLoader(reader, batch, device=device, last_batch='drop', prefetch=4) as loader:
            svc_state = train(loader, stop_after=preempt_after)
    finally:
        reader.stop()
        reader.join()
        for s in servers:
            s.stop()
    if svc_state is None:
        raise RuntimeError('the epoch ended before the checkpoint')

    # Session 2: fresh servers and a fresh trainer from the state.
    servers = _start_servers(url, sockets, states=svc_state['server_states'])
    reader = RemoteReader([s.data_endpoint for s in servers], resume_state=svc_state)
    try:
        with TorchLoader(reader, batch, device=device, last_batch='drop', prefetch=4) as loader:
            train(loader)
    finally:
        reader.stop()
        reader.join()
        for s in servers:
            s.stop()

    shutil.rmtree(sockets, ignore_errors=True)
    # Exactly once across the teardown, but for the tails under one batch
    # that last_batch='drop' leaves.
    if len(seen) != len(set(seen)):
        raise AssertionError('rows delivered twice across the service resume')
    if n_rows - len(set(seen)) >= batch * 2:
        raise AssertionError('rows lost across the service resume')
    print('data service example: 2 servers, {} steps, {} distinct rows of {}, {} chunk(s) in '
          'flight at the checkpoint'.format(len(losses), len(set(seen)), n_rows,
                                             len(svc_state['pending'])))
    return losses, seen, len(svc_state['pending'])


def _serve_subprocess(url, bind, snapshot_path, resume):
    """``--_serve``: one server process with self-snapshots armed."""
    import json
    import time

    from petastorm_tpu_torch.data_service import load_server_snapshot, serve_dataset

    snapshot = load_server_snapshot(snapshot_path) if resume else None
    # The replay ring must cover every chunk a SIGKILL can strand unsent.
    # Chunks this small (~0.5 KB) batch up in zmq's output buffer beyond
    # sndhwm, so the ring is far deeper than the default sndhwm + 4.
    server = serve_dataset(url, bind, snapshot_path=snapshot_path, snapshot_every=2,
                           snapshot_resume=snapshot, replay_ring_chunks=64, num_epochs=1,
                           seed=0, workers_count=1, shuffle_row_groups=False)
    print(json.dumps({'data_endpoint': server.data_endpoint}), flush=True)
    while True:         # serves until the process is killed
        time.sleep(0.5)


def run_crash_recovery(n_rows=192, device='cuda'):
    """Two server processes, one SIGKILLed mid-stream and restarted from its
    snapshot; the trainer rides through. Returns the duplicate chunks the
    trainer dropped."""
    import collections
    import json
    import subprocess

    from petastorm_tpu_torch import TorchLoader
    from petastorm_tpu_torch.data_service import RemoteReader

    url = 'file://' + tempfile.mkdtemp(prefix='pstt-svc-crash-store-')
    _write_store(url, n_rows)
    workdir = tempfile.mkdtemp(prefix='pstt-svc-crash-')
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env['PYTHONPATH'] = os.pathsep.join(filter(None, [root, env.get('PYTHONPATH')]))

    def spawn(name, resume=False):
        cmd = [sys.executable, '-m', 'petastorm_tpu_torch.examples.serve_and_train', '--_serve',
               url, 'ipc://' + os.path.join(workdir, name), os.path.join(workdir, name + '.pkl')]
        proc = subprocess.Popen(cmd + (['--resume'] if resume else []), stdout=subprocess.PIPE,
                                text=True, env=env)
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError('server {} died before it printed its endpoint'.format(name))
        return proc, json.loads(line)

    state, train_step = _trainer(device)
    procs = []
    try:
        proc_a, info_a = spawn('a')
        proc_b, info_b = spawn('b')
        procs += [proc_a, proc_b]
        seen = []
        with RemoteReader([info_a['data_endpoint'], info_b['data_endpoint']], rcvhwm=1,
                          end_grace_s=10.0) as remote:
            with TorchLoader(remote, 8, device=device, prefetch=1) as loader:
                it = iter(loader)
                for _ in range(4):                      # train a little...
                    b = next(it)
                    train_step(state, b.x, b.label)
                    seen.extend(b.sample_id.tolist())
                proc_a.kill()                           # ...SIGKILL a server...
                proc_a.wait()
                proc_a2, _ = spawn('a', resume=True)    # ...restart it from its snapshot
                procs.append(proc_a2)
                for b in it:                            # the trainer never restarts
                    train_step(state, b.x, b.label)
                    seen.extend(b.sample_id.tolist())
            dups = remote.diagnostics['duplicate_chunks']
        counts = collections.Counter(seen)
        if sorted(counts) != list(range(n_rows)):
            raise AssertionError('rows lost in the crash')
        if set(counts.values()) != {2}:
            raise AssertionError('rows delivered other than once per server: {}'.format(
                sorted(set(counts.values()))))
        print('crash-recovery example: each of {} rows delivered once per server across a '
              'SIGKILL; {} replayed chunk(s) dropped by (server_id, seq)'.format(n_rows, dups))
        return dups
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(workdir, ignore_errors=True)
        shutil.rmtree(url[len('file://'):], ignore_errors=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if '--_serve' in argv:          # a crash demo's server process
        i = argv.index('--_serve')
        _serve_subprocess(argv[i + 1], argv[i + 2], argv[i + 3], '--resume' in argv)
        return
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--dataset-url', default=None)
    parser.add_argument('--batch', type=int, default=8)
    parser.add_argument('--rows', type=int, default=None,
                        help='rows of the store (default 96, and 192 for the crash demo)')
    parser.add_argument('--preempt-after', type=int, default=3)
    parser.add_argument('--demo', choices=['checkpoint', 'crash'], default='checkpoint')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    if args.demo == 'crash':
        run_crash_recovery(n_rows=args.rows or 192, device=args.device)
        return
    run(dataset_url=args.dataset_url, batch=args.batch, n_rows=args.rows or 96,
        preempt_after=args.preempt_after, device=args.device)


if __name__ == '__main__':
    main()
