"""Reader throughput harness (counterpart of ``petastorm_tpu/benchmark/``)."""

from petastorm_tpu_torch.benchmark.throughput import (BenchmarkResult,  # noqa: F401
                                                      reader_throughput)
