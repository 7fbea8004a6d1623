"""Native (C++) host components of the port, built at first use with ``g++``
and loaded through ``ctypes`` (counterpart of ``petastorm_tpu/native/``, its
own copy of the sources):

- :mod:`petastorm_tpu_torch.native.image`: the JPEG/PNG codec on libjpeg and
  libpng, with a multithreaded batch decode that releases the GIL for the
  whole call (``src/image_codec.cc``).
- :mod:`petastorm_tpu_torch.native.parquet`: the Parquet row-group stage,
  linked against the installed pyarrow wheel's libarrow/libparquet, whose
  record batches cross into pyarrow through the Arrow C Data Interface
  without a copy (``src/parquet_stage.cc``).
- :mod:`petastorm_tpu_torch.native.shm_ring`: the shared-memory ring of
  the process pool on shared memory (``src/shm_ring.cc``, ``-lrt``), its
  pages reserved when it is made.

Each degrades as the JAX package's does: when the toolchain, a header or a
library is missing, ``available()`` is False, the build error is kept
(``load_error()``), and the callers take the OpenCV/PIL and pyarrow paths
(``reader_pool_type='process'``: zmq). All are built by
:mod:`~petastorm_tpu_torch.native.build`.
"""
