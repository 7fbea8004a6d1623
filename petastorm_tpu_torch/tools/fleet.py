"""``python -m petastorm_tpu_torch.tools.fleet``: a preprocessing-fleet
worker and the fleet status probe (counterpart of
``petastorm_tpu/tools/fleet.py``).

``--worker DATASET_URL``
    One fleet worker: a :func:`~petastorm_tpu_torch.data_service.
    serve_dataset` server joined to ``--job`` (its heartbeats carry the job
    and capacity announce the registry folds into membership), with
    optional per-tenant quotas (``--tenant-quotas``). It prints one JSON
    announce line (server id, endpoints, job), the line
    :class:`~petastorm_tpu_torch.fleet.autoscaler.SubprocessLauncher` reads,
    then serves until the stream ends or a signal lands: the first
    SIGTERM/SIGINT drains (exit 0 = drained), a second tears down. The
    ``fleet-worker-kill`` site fires right after the announce. The worker
    hides the card (``CUDA_VISIBLE_DEVICES`` empty) before it imports the
    service, and imports no torch.

``--status``
    Probe a fleet and print one JSON line: each ``--rpc`` endpoint's
    ``fleet`` verb and the fleet-aggregated ``pst_fleet_tenant_*`` series;
    exit 0 when every endpoint answered.
"""

import argparse
import json
import signal
import sys
import threading

#: Tenant SLO series surfaced in the --status snapshot.
_TENANT_METRIC_PREFIX = 'pst_fleet_tenant_'


def _status(args):
    import zmq

    from petastorm_tpu_torch import metrics as metrics_mod
    from petastorm_tpu_torch.serving.server import _one_shot

    context = zmq.Context.instance()

    def _rpc(endpoint, request):
        return _one_shot(context, endpoint, request,
                         timeout_ms=int(args.timeout_s * 1000))

    members = {}
    unreachable = []
    for ep in args.rpc:
        try:
            reply = _rpc(ep, {'cmd': 'fleet'})
        except Exception:  # noqa: BLE001 - a dead member is a data point
            unreachable.append(ep)
            continue
        sid = reply.get('server_id')
        if isinstance(sid, (bytes, bytearray)):
            reply['server_id'] = bytes(sid).hex()
        members[ep] = {k: reply.get(k) for k in
                       ('server_id', 'state', 'job', 'capacity',
                        'consumers', 'sent', 'tenants')}
    fleet = metrics_mod.scrape_fleet_metrics(
        args.rpc, lambda ep: _rpc(ep, {'cmd': 'metrics'}))
    tenant_slo = {name: metric for name, metric
                  in (fleet.get('aggregate') or {}).items()
                  if name.startswith(_TENANT_METRIC_PREFIX)}
    print(json.dumps({'members': members,
                      'tenant_slo': tenant_slo,
                      'unreachable': sorted(set(unreachable)
                                            | set(fleet['unreachable']))},
                     default=str), flush=True)
    return 1 if (unreachable or fleet['unreachable']) else 0


def _worker(args):
    import os
    # A decode tier on a GPU host: no CUDA context in this process.
    os.environ['CUDA_VISIBLE_DEVICES'] = ''
    from petastorm_tpu_torch import faults
    from petastorm_tpu_torch.data_service import serve_dataset
    from petastorm_tpu_torch.fleet.tenancy import TenantLedger, TenantQuota

    tenants = None
    if args.tenant_quotas:
        quotas = {tenant: TenantQuota.coerce(kwargs) for tenant, kwargs
                  in json.loads(args.tenant_quotas).items()}
        tenants = TenantLedger(quotas=quotas)

    # Handlers before the (possibly slow) dataset open, the serve CLI's
    # contract: the first signal drains, the second forces.
    drain_requested = threading.Event()
    stop = threading.Event()

    def _on_signal(*_):
        if drain_requested.is_set():
            stop.set()
        else:
            drain_requested.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, _on_signal)

    reader_kwargs = {'workers_count': args.workers,
                     'num_epochs': None if args.epochs == 0 else args.epochs}
    if args.deterministic:
        reader_kwargs['deterministic'] = True
    if args.seed is not None:
        reader_kwargs['seed'] = args.seed

    server = serve_dataset(args.dataset_url, args.bind,
                           sndhwm=args.sndhwm,
                           lease_s=args.lease_s,
                           max_consumers=args.max_consumers,
                           await_cursor=args.await_cursor,
                           job_id=args.job,
                           tenants=tenants,
                           **reader_kwargs)
    # The announce line the launcher blocks on. server_id hex IS the
    # registry member key (binary heartbeats carry no separate name), so
    # the launcher can wait_for_member() on exactly this worker.
    print(json.dumps({'server_id': server._server_id.hex(),
                      'job': args.job,
                      'data_endpoint': server.data_endpoint,
                      'control_endpoint': server.control_endpoint,
                      'rpc_endpoint': server.rpc_endpoint,
                      'state': server.state}), flush=True)
    # Chaos seam: a worker that dies AFTER announcing but BEFORE its
    # first heartbeat reaches the registry — the mid-scale-up SIGKILL
    # the autoscaler's spawn-grace reap exists for.
    faults.maybe_inject('fleet-worker-kill')

    drained = False
    while not stop.is_set():
        if drain_requested.is_set():
            server.drain(timeout_s=0)
        if server.wait(0.5):
            drained = server.state == 'drained'
            stop.wait(args.drain_grace)
            break
    drained = drained or server.state == 'drained'
    final = {'state': 'drained' if drained
             else ('stopped' if stop.is_set() else 'served'),
             'served_chunks': server.served_chunks}
    server.stop()
    if tenants is not None:
        tenants.close()
    print(json.dumps(final), flush=True)
    # Exit 0 only on a clean drain or full serve: the launcher's
    # drain() judges zero-loss by this code.
    return 0 if (drained or final['state'] == 'served') else 1


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='petastorm_tpu_torch preprocessing-fleet worker / status '
                    'probe')
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument('--worker', action='store_true',
                      help='run one fleet worker (announce, serve, '
                           'drain on SIGTERM)')
    mode.add_argument('--status', action='store_true',
                      help='print one JSON line of fleet membership + '
                           'per-tenant SLO snapshot')
    parser.add_argument('dataset_url', nargs='?',
                        help='dataset to serve (--worker)')
    parser.add_argument('--job', default=None,
                        help='fleet job id (default: PSTT_FLEET_JOB)')
    parser.add_argument('--bind', default='tcp://127.0.0.1:*',
                        help='zmq data endpoint (--worker); control/rpc '
                             'take the next two ports, or <path>.1 and '
                             '<path>.2 of an ipc:// path')
    parser.add_argument('--workers', type=int, default=2)
    parser.add_argument('--epochs', type=int, default=1,
                        help='epochs to serve; 0 = infinite')
    parser.add_argument('--deterministic', action='store_true')
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--sndhwm', type=int, default=4)
    parser.add_argument('--max-consumers', type=int, default=None)
    parser.add_argument('--lease-s', type=float, default=None)
    parser.add_argument('--await-cursor', action='store_true',
                        help='defer the reader build until a consumer '
                             'ships a resume cursor (replacement worker '
                             'in a deterministic fleet)')
    parser.add_argument('--tenant-quotas', default=None, metavar='JSON',
                        help='per-tenant quota dict, e.g. '
                             '\'{"a": {"max_consumers": 2, '
                             '"credits": 8, "mem_budget": "512m"}}\'')
    parser.add_argument('--drain-grace', type=float, default=5.0)
    parser.add_argument('--rpc', nargs='*', default=[],
                        help='worker rpc endpoints to probe (--status)')
    parser.add_argument('--timeout-s', type=float, default=5.0,
                        help='per-endpoint probe deadline (--status)')
    args = parser.parse_args(argv)

    if args.status:
        if not args.rpc:
            parser.error('--status needs at least one --rpc endpoint')
        return _status(args)
    if not args.dataset_url:
        parser.error('--worker needs a dataset_url')
    return _worker(args)


if __name__ == '__main__':
    sys.exit(main())
