"""Run a data-service server from the shell (counterpart of
``petastorm_tpu/tools/serve_cli.py``)::

    python -m petastorm_tpu_torch.tools.serve_cli file:///data/store \\
        --bind ipc:///run/pstt/data --workers 8 --epochs 0

One process reads, decodes and streams a dataset to trainers
(:class:`~petastorm_tpu_torch.data_service.RemoteReader`), so the decode
tier runs under a process supervisor instead of inside the training
process. It prints one JSON line with its endpoints (trainers dial
``data_endpoint``) and serves until the stream is done. The first SIGTERM
or SIGINT drains (the in-flight chunk completes, an exact END goes out, the
last line says ``drained``); a second one stops at once. ``--snapshot-path``
arms self-snapshots and ``--resume`` restarts a SIGKILLed server from one on
the same endpoint. The process imports no torch; run it with
``CUDA_VISIBLE_DEVICES=''`` beside a trainer on a GPU host.
"""

import argparse
import json
import signal
import sys
import threading


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Serve a petastorm_tpu_torch dataset to remote trainers')
    parser.add_argument('dataset_url')
    parser.add_argument('--bind', default='tcp://*:5555',
                        help='zmq data endpoint (default tcp://*:5555; '
                             'control/rpc default to the next two ports, or '
                             'to <path>.1 and <path>.2 of an ipc:// path)')
    parser.add_argument('--fields', nargs='*', default=None,
                        help='schema field names/regexes (default: all)')
    parser.add_argument('--workers', type=int, default=4)
    parser.add_argument('--epochs', type=int, default=1,
                        help='epochs to serve; 0 = infinite')
    parser.add_argument('--cache-type', default='null',
                        choices=['null', 'memory'])
    parser.add_argument('--shuffle-row-groups', action='store_true')
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--deterministic', action='store_true',
                        help='deterministic stream mode: chunk order is a '
                             'pure function of (dataset, seed, epoch, '
                             'position), chunks carry stream-cursor tags, '
                             'and a sole consumer can reconnect to a '
                             'replacement server bit-identically '
                             '(--await-cursor on the replacement)')
    parser.add_argument('--sndhwm', type=int, default=4,
                        help='per-consumer chunk buffer (backpressure)')
    parser.add_argument('--batch-reader', action='store_true',
                        help='serve a plain-Parquet store via '
                             'make_batch_reader instead of the decoded '
                             'tensor reader')
    parser.add_argument('--auth-key-file', default=None,
                        help='file whose bytes key the stream MACs '
                             '(consumers pass the same auth_key)')
    parser.add_argument('--snapshot-path', default=None,
                        help='arm periodic self-snapshots (crash recovery)')
    parser.add_argument('--snapshot-every', type=int, default=16)
    parser.add_argument('--resume', default=None, metavar='SNAPSHOT',
                        help='restart from a snapshot written by a '
                             'previous --snapshot-path run')
    parser.add_argument('--drain-grace', type=float, default=5.0,
                        help='seconds to keep sockets open after the '
                             'stream is served: lets zmq flush queued '
                             'chunks and the END broadcast reach slow '
                             'consumers before teardown (default 5)')
    parser.add_argument('--metrics-port', type=int, default=None,
                        metavar='PORT',
                        help='start the Prometheus scrape endpoint '
                             '(petastorm_tpu_torch.metrics.MetricsExporter) on '
                             'this port; 0 binds an ephemeral port. The '
                             'bound URL is printed as metrics_endpoint in '
                             'the JSON status line. Until now the exporter '
                             'was reachable only programmatically — this '
                             'makes a shell-deployed decode tier scrapable.')
    parser.add_argument('--no-lineage', action='store_true',
                        help='do not ship per-chunk provenance segments on '
                             'the wire; required while any trainer predates '
                             'the lineage sidecar (old consumers crash '
                             'unpacking the reserved payload key)')
    parser.add_argument('--max-consumers', type=int, default=None,
                        metavar='N',
                        help='admission-control capacity: consumers past N '
                             'get a typed ServerOverloaded refusal at '
                             'attach instead of degrading everyone')
    parser.add_argument('--lease-s', type=float, default=None,
                        help='control-plane lease duration (heartbeats go '
                             'out at a third of it; consumers declare the '
                             'server dead one lease after the last one). '
                             'Default: PSTT_LEASE_S or 10')
    parser.add_argument('--await-cursor', action='store_true',
                        help='defer the reader build until the first '
                             'consumer attaches: a REPLACEMENT server for '
                             'a dead deterministic peer then resumes from '
                             'the consumer\'s shipped cursor and continues '
                             'the stream bit-identically (reader flags '
                             'here must match the dead server\'s)')
    args = parser.parse_args(argv)

    from petastorm_tpu_torch.data_service import serve_dataset

    auth_key = None
    if args.auth_key_file:
        # Verbatim file bytes: stripping would silently alter binary keys
        # whose edge bytes are ASCII whitespace, and the consumers MAC
        # with the raw bytes they loaded.
        with open(args.auth_key_file, 'rb') as f:
            auth_key = f.read()

    if (args.snapshot_path or args.resume) and args.workers != 1 and not args.deterministic:
        # Crash recovery dedupes by (server_id, seq): resume must re-produce
        # chunks in the original order, which a deterministic reader does
        # with any number of workers, and any other reader with one.
        print('serve_cli: snapshot/resume requires deterministic '
              'chunk order; forcing --workers 1 (was {})'.format(args.workers),
              file=sys.stderr, flush=True)
        args.workers = 1

    reader_kwargs = {
        'workers_count': args.workers,
        'num_epochs': None if args.epochs == 0 else args.epochs,
        'cache_type': args.cache_type,
        'shuffle_row_groups': args.shuffle_row_groups,
    }
    if args.deterministic:
        reader_kwargs['deterministic'] = True
    if args.seed is not None:
        reader_kwargs['seed'] = args.seed
    if args.fields:
        reader_kwargs['schema_fields'] = args.fields
    if args.batch_reader:
        from petastorm_tpu_torch import make_batch_reader
        reader_kwargs['reader_factory'] = make_batch_reader

    # Handlers first: a supervisor's SIGTERM during a slow dataset open
    # must request clean teardown, not take the default kill and orphan
    # pool workers. The FIRST signal requests a graceful drain (finish
    # the in-flight chunk, broadcast an exact END, report `drained`); a
    # SECOND one forces immediate teardown.
    drain_requested = threading.Event()
    stop = threading.Event()

    def _on_signal(*_):
        if drain_requested.is_set():
            stop.set()
        else:
            drain_requested.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, _on_signal)

    exporter = None
    if args.metrics_port is not None:
        # Before the (possibly slow) dataset open: a supervisor's scrape
        # target should answer from process start, and a bind failure on a
        # chosen port must fail fast, not after minutes of store listing.
        from petastorm_tpu_torch.metrics import start_http_exporter
        exporter = start_http_exporter(port=args.metrics_port)

    try:
        server = serve_dataset(args.dataset_url, args.bind,
                               sndhwm=args.sndhwm, auth_key=auth_key,
                               snapshot_path=args.snapshot_path,
                               snapshot_every=args.snapshot_every,
                               snapshot_resume=args.resume,
                               lineage=not args.no_lineage,
                               lease_s=args.lease_s,
                               max_consumers=args.max_consumers,
                               await_cursor=args.await_cursor,
                               **reader_kwargs)
    except BaseException:
        if exporter is not None:
            exporter.stop()
        raise
    status = {'data_endpoint': server.data_endpoint,
              'control_endpoint': server.control_endpoint,
              'rpc_endpoint': server.rpc_endpoint,
              'state': server.state}
    if exporter is not None:
        status['metrics_endpoint'] = exporter.address
    print(json.dumps(status), flush=True)

    # wait() fires when the READER is exhausted — up to sndhwm chunks can
    # still sit in the zmq send queue and the END broadcast keeps repeating
    # for slow joiners, so hold the sockets open for a drain grace before
    # stop() (which closes with linger=0, discarding anything queued).
    drained = False
    while not stop.is_set():
        if drain_requested.is_set():
            # Graceful drain (first SIGTERM/SIGINT): stop admitting,
            # finish the in-flight chunk, END with the exact served count
            # — zero chunks lost, and the final stream cursor lands in
            # the server's stats for a replacement to pick up. Non-
            # blocking: the wait() below observes completion, and a
            # second signal still forces teardown promptly.
            server.drain(timeout_s=0)
        if server.wait(0.5):
            drained = server.state == 'drained'
            stop.wait(args.drain_grace)
            break
    final = {'state': 'drained' if (drained or server.state == 'drained')
             else ('stopped' if stop.is_set() else 'served'),
             'served_chunks': server.served_chunks}
    server.stop()
    print(json.dumps(final), flush=True)
    if exporter is not None:
        exporter.stop()
    return 0


if __name__ == '__main__':
    sys.exit(main())
