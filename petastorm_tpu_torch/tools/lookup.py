"""``python -m petastorm_tpu_torch.tools.lookup``: smoke-test the lookup
tier (counterpart of ``petastorm_tpu/tools/lookup.py``).

One command runs the whole path: build the row-level key index, resolve a
point read through the chunk-store hot tier, and optionally stand the rpc
server up::

    # index the 'id' field, read id=7, report per-field CRC32 digests
    python -m petastorm_tpu_torch.tools.lookup --dataset-url file:///data/ds \\
        --key id=7 --build-index

    # the same dataset as a service (the trainers' chunk store as hot tier)
    python -m petastorm_tpu_torch.tools.lookup --dataset-url file:///data/ds \\
        --key id=7 --store /mnt/nvme/chunks --serve

It prints one JSON line an action (index build, lookup result, serve
status). The lookup result carries per-field CRC32 digests
(``lineage._digest_array``, the provenance ledger's digest), which proves a
served row byte-identical to the training feed's.

``--fleet EP ...`` dials a running fleet instead (routing table,
per-partition replica health, the scatter-gather read and scatter stats,
one JSON line each); on the server side ``--serve --partitions N``
bootstraps a one-member fleet and ``--serve --join PEER`` joins one,
warm-filling the chunk store from the peer unless ``--no-warm``. The first
SIGTERM drains (a fleet member first reassigns its key range), the second
stops at once. The lines and exit codes are the JAX package's (exit 3 on
a key with no match). The process imports no torch.
"""

import argparse
import json
import signal
import sys
import threading


def _field_summary(name, value):
    """JSON-safe description of one served field: dtype/shape/CRC32,
    plus the value itself when it is a printable scalar."""
    import numpy as np

    from petastorm_tpu_torch.lineage import _digest_array
    arr = np.asarray(value)
    out = {'dtype': str(arr.dtype), 'shape': list(arr.shape),
           'crc32': '{:#010x}'.format(_digest_array(arr))}
    if arr.ndim == 0 and arr.dtype.kind in 'biufU':
        out['value'] = arr.item()
    return out


def _fleet_client(args, field, value):
    """``--fleet`` mode: routing table, per-partition replica health,
    the scatter-gather read, and scatter stats — one JSON line each."""
    from petastorm_tpu_torch.serving import LookupClient
    client = LookupClient(args.fleet,
                          control_endpoints=args.control,
                          timeout_ms=args.timeout_ms)
    try:
        try:
            client.refresh_partition_map()
        except Exception as e:  # noqa: BLE001 - a CLI prints, not dies
            print(json.dumps({'action': 'pmap-refresh',
                              'error': repr(e)}), flush=True)
        table = client.routing_table()
        print(json.dumps({'action': 'routing-table', 'table': table}),
              flush=True)
        health = {pid: [{'name': e['name'],
                         'endpoint': e['endpoint'],
                         'breaker': e['breaker'],
                         'hb_state': e['hb_state'],
                         'lease_fresh': e['lease_fresh']}
                        for e in entries]
                  for pid, entries in table['partitions'].items()}
        print(json.dumps({'action': 'partition-health',
                          'version': table['version'],
                          'partitions': health}), flush=True)
        try:
            rows = client.lookup([value])[0]
        except Exception as e:  # noqa: BLE001
            print(json.dumps({'action': 'lookup', 'key': args.key,
                              'error': repr(e)}), flush=True)
            return 1
        print(json.dumps({'action': 'lookup', 'key': args.key,
                          'matches': len(rows),
                          'rows': [{name: _field_summary(name, val)
                                    for name, val in row.items()}
                                   for row in rows]}), flush=True)
        print(json.dumps({'action': 'scatter-stats',
                          'stats': client.scatter_stats()}), flush=True)
        return 0 if rows else 3
    finally:
        client.close()


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Point reads over a petastorm_tpu_torch dataset: build the '
                    'row-level index, look keys up, optionally serve rpc')
    parser.add_argument('--dataset-url', default=None,
                        help='the dataset to open (required unless '
                             '--fleet dials running servers instead)')
    parser.add_argument('--key', required=True, metavar='FIELD=VALUE',
                        help='the point read, e.g. id=7; FIELD names the '
                             'indexed key field')
    parser.add_argument('--fleet', nargs='+', default=None,
                        metavar='ENDPOINT',
                        help='client mode: dial these lookup rpc '
                             'endpoints, print the routing table, '
                             'per-partition replica health, the '
                             'scatter-gather read, and scatter stats '
                             'as JSON lines')
    parser.add_argument('--control', nargs='*', default=None,
                        metavar='ENDPOINT',
                        help='heartbeat endpoints for --fleet (lease-'
                             'aware ranking; the partition map also '
                             'arrives here)')
    parser.add_argument('--timeout-ms', type=int, default=5000,
                        help='--fleet whole-request (per-partition) '
                             'deadline')
    parser.add_argument('--build-index', action='store_true',
                        help='run the SingleFieldRowIndexer pass over the '
                             'key field first (persists alongside any '
                             'existing indexes)')
    parser.add_argument('--index', default=None,
                        help='row-level index name (default: the single '
                             'stored one, or FIELD_row_ix when building)')
    parser.add_argument('--store', default=None, metavar='DIR',
                        help='DecodedChunkStore directory — share the '
                             'training store so point reads hit its mmap '
                             'tier (default: decode-only)')
    parser.add_argument('--fields', nargs='*', default=None,
                        help='fields to serve (default: all)')
    parser.add_argument('--serve', action='store_true',
                        help='after the lookup, serve lookup/query rpc '
                             'until SIGTERM (first signal drains '
                             'gracefully, second forces exit)')
    parser.add_argument('--bind', default='tcp://127.0.0.1:*',
                        help='rpc endpoint for --serve (heartbeats bind '
                             'the next port, or <path>.1 of an ipc:// path)')
    parser.add_argument('--max-consumers', type=int, default=None)
    parser.add_argument('--lease-s', type=float, default=None)
    parser.add_argument('--rpc-workers', type=int, default=2)
    parser.add_argument('--name', default=None,
                        help='fleet identity of a --serve server '
                             '(placement assigns partitions to it)')
    parser.add_argument('--partitions', type=int, default=None,
                        help='--serve: bootstrap a one-member fleet '
                             'with this many hash partitions')
    parser.add_argument('--replication', type=int, default=2,
                        help='replica target R for --partitions')
    parser.add_argument('--join', default=None, metavar='PEER_ENDPOINT',
                        help='--serve: join the fleet this peer serves')
    parser.add_argument('--no-warm', action='store_true',
                        help='with --join: skip the peer cache '
                             'warm-fill (cold-decode on first reads)')
    args = parser.parse_args(argv)

    field, sep, value = args.key.partition('=')
    if not sep or not field:
        print(json.dumps({'error': '--key must be FIELD=VALUE, got {!r}'
                          .format(args.key)}), flush=True)
        return 2

    if args.fleet:
        return _fleet_client(args, field, value)
    if not args.dataset_url:
        print(json.dumps({'error': '--dataset-url is required without '
                                   '--fleet'}), flush=True)
        return 2

    from petastorm_tpu_torch.serving import LookupEngine, LookupServer

    index_name = args.index
    if args.build_index:
        from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldRowIndexer
        from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index
        index_name = index_name or '{}_row_ix'.format(field)
        payload = build_rowgroup_index(
            args.dataset_url, [SingleFieldRowIndexer(index_name, field)])
        print(json.dumps({'action': 'build-index', 'index': index_name,
                          'field': field,
                          'keys': len(payload[index_name]['values'])}),
              flush=True)

    try:
        engine = LookupEngine(args.dataset_url, index_name=index_name,
                              cache=args.store, schema_fields=args.fields)
    except Exception as e:  # noqa: BLE001 - a CLI prints, not tracebacks
        print(json.dumps({'error': str(e)}), flush=True)
        return 1
    if engine.index.field != field:
        print(json.dumps({'error': 'index {!r} keys field {!r}, not {!r}'
                          .format(engine.index.name, engine.index.field,
                                  field)}), flush=True)
        engine.close()
        return 1

    rows = engine.lookup([value])[0]
    print(json.dumps({'action': 'lookup', 'key': args.key,
                      'matches': len(rows),
                      'rows': [{name: _field_summary(name, val)
                                for name, val in row.items()}
                               for row in rows],
                      'engine': engine.stats()}), flush=True)

    if not args.serve:
        engine.close()
        return 0 if rows else 3

    drain_requested = threading.Event()
    stop = threading.Event()

    def _on_signal(*_):
        if drain_requested.is_set():
            stop.set()
        else:
            drain_requested.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, _on_signal)

    server = LookupServer(engine, args.bind,
                          lease_s=args.lease_s,
                          max_consumers=args.max_consumers,
                          rpc_workers=args.rpc_workers,
                          server_name=args.name).start()
    if args.partitions:
        pmap = server.init_fleet(n_partitions=args.partitions,
                                 replication=args.replication)
        print(json.dumps({'action': 'init-fleet',
                          'name': server.server_name,
                          'version': pmap.version,
                          'n_partitions': pmap.n_partitions,
                          'replication': pmap.replication}), flush=True)
    elif args.join:
        try:
            summary = server.join_fleet(args.join,
                                        warm=not args.no_warm)
        except Exception as e:  # noqa: BLE001 - a CLI prints, not dies
            print(json.dumps({'action': 'join-fleet',
                              'error': repr(e)}), flush=True)
            server.stop()
            engine.close()
            return 1
        print(json.dumps(dict({'action': 'join-fleet',
                               'name': server.server_name}, **summary)),
              flush=True)
    print(json.dumps({'action': 'serve',
                      'rpc_endpoint': server.rpc_endpoint,
                      'control_endpoint': server.control_endpoint,
                      'state': server.state}), flush=True)
    while not stop.is_set():
        if drain_requested.is_set():
            server.drain()
            break
        stop.wait(0.2)
    final = {'action': 'served', 'state': server.state,
             'requests_served': server.requests_served}
    server.stop()
    engine.close()
    print(json.dumps(final), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
