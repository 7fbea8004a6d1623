"""Reader throughput from the command line (counterpart of
``petastorm_tpu/benchmark/cli.py``)::

    python -m petastorm_tpu_torch.benchmark.cli URL [-d python|torch] [--device cpu]
        [-p thread|process|process-shm|process-zmq|dummy] [--spawn-new-process]
        [--profile-threads]
"""

import argparse
import sys

from petastorm_tpu_torch.benchmark.throughput import READ_METHODS, reader_throughput


def main(argv=None):
    parser = argparse.ArgumentParser(description='Measure reader throughput on a dataset')
    parser.add_argument('dataset_url', help='e.g. file:///tmp/ds')
    parser.add_argument('--field-regex', '-f', nargs='+', default=None,
                        help='read only fields matching these regexes')
    parser.add_argument('--warmup-cycles', '-w', type=int, default=200)
    parser.add_argument('--measure-cycles', '-m', type=int, default=1000)
    parser.add_argument('--pool-type', '-p', default='thread',
                        choices=['thread', 'process', 'process-shm', 'process-zmq', 'dummy'])
    parser.add_argument('--loaders-count', '-l', type=int, default=3)
    parser.add_argument('--read-method', '-d', choices=READ_METHODS, default='python')
    parser.add_argument('--shuffling-queue-size', '-q', type=int, default=500)
    parser.add_argument('--min-after-dequeue', type=int, default=400)
    parser.add_argument('--torch-batch-size', type=int, default=32)
    parser.add_argument('--device', default='cuda', help="'torch' batches' device")
    parser.add_argument('--spawn-new-process', action='store_true',
                        help='measure in a fresh interpreter (clean memory numbers)')
    parser.add_argument('--profile-threads', action='store_true',
                        help="print the thread pool's workers' cProfile at the end")
    args = parser.parse_args(argv)
    result = reader_throughput(
        args.dataset_url, field_regex=args.field_regex, warmup_cycles_count=args.warmup_cycles,
        measure_cycles_count=args.measure_cycles, pool_type=args.pool_type,
        loaders_count=args.loaders_count, read_method=args.read_method,
        shuffling_queue_size=args.shuffling_queue_size,
        min_after_dequeue=args.min_after_dequeue, torch_batch_size=args.torch_batch_size,
        device=args.device, spawn_new_process=args.spawn_new_process,
        profile_threads=args.profile_threads)
    rss = 'n/a' if result.memory_rss_mb is None else '{:.1f} MB'.format(result.memory_rss_mb)
    cpu = 'n/a' if result.cpu_percent is None else '{:.1f}%'.format(result.cpu_percent)
    print('samples/sec: {:.2f}  time/sample: {:.6f}s  rss: {}  cpu: {}'.format(
        result.samples_per_second, result.time_mean, rss, cpu))
    return 0


if __name__ == '__main__':
    sys.exit(main())
