"""Run a function on N ranks of one host, one process each, for the CPU
(``gloo``) runs of the multi-rank paths: the tests and
``python -m petastorm_tpu_torch.parallel.dryrun --spawn N``.

On GPUs the ranks come from ``torchrun --nproc-per-node=N`` instead; this
helper is the same process model without it. The group starts from a file
(``init_method='file://...'``), never a fixed TCP port, so concurrent runs
on one host cannot collide; each rank uses one intra-op thread; a rank that
has not finished by ``timeout`` is killed with the rest and the call raises.
"""

import contextlib
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp




@contextlib.contextmanager
def init_from_env(device='cuda'):
    """Join the job ``torchrun`` started (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK`` in the environment):
    NCCL on this rank's GPU, or gloo with ``device='cpu'``; yields the
    rank's ``torch.device`` and destroys the group on the way out."""
    cpu = torch.device(device).type == 'cpu'
    if cpu:
        dev = torch.device('cpu')
        dist.init_process_group('gloo')
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("device {!r} requested but torch.cuda.is_available() is False; "
                               "pass device='cpu' to run on the host".format(str(device)))
        dev = torch.device('cuda', int(os.environ.get('LOCAL_RANK', '0')))
        torch.cuda.set_device(dev)
        dist.init_process_group('nccl', device_id=dev)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def _rank_main(rank, world, init_file, fn, args, results):
    torch.set_num_threads(1)
    try:
        dist.init_process_group('gloo', init_method='file://' + os.path.abspath(init_file),
                                rank=rank, world_size=world)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.barrier()
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 - the parent raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world, args=(), timeout=120.0, workdir=None):
    """``[fn(rank, world, *args) for rank in range(world)]``, each call in
    its own process inside a ``gloo`` group of ``world`` ranks. ``fn`` must
    be importable (a module-level function). Raises ``RuntimeError`` with
    the failing rank's traceback, or on timeout after killing every rank."""
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix='pstt-spawn-', dir=workdir)
    init_file = os.path.join(tmp, 'init')
    procs = [ctx.Process(target=_rank_main, name='pstt-rank-{}'.format(rank),
                         args=(rank, world, init_file, fn, args, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(out) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError('{} of {} ranks did not finish within {} s'.format(
                    world - len(out) - len(errors), world, timeout))
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    time.sleep(0.5)
                    if results.empty():
                        raise RuntimeError('rank process(es) {} died with exit codes {}'.format(
                            [p.name for p in dead], [p.exitcode for p in dead]))
                continue
            if ok:
                out[rank] = pickle.loads(payload)
            else:
                errors.append((rank, payload))
                break
        if errors:
            rank, trace = errors[0]
            raise RuntimeError('rank {} failed:\n{}'.format(rank, trace))
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
        try:
            os.remove(init_file)
        except OSError:
            pass
        try:
            os.rmdir(tmp)
        except OSError:
            pass
    return [out[rank] for rank in range(world)]
