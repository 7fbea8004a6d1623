"""Dataset URL resolution: URL -> (fsspec filesystem, in-filesystem path).

Counterpart of ``petastorm_tpu/fs.py``. Every store goes through fsspec:
``file://`` (or a bare absolute path) is the local disk, ``gs://`` and
``gcs://`` GCS, ``s3://`` S3, ``abfs://`` Azure, ``memory://`` fsspec's
in-process filesystem, ``webhdfs://`` WebHDFS, and ``hdfs://`` HDFS through
:mod:`~petastorm_tpu_torch.hdfs` (a nameservice netloc gets namenode
failover). ``storage_options`` are the fsspec driver's keyword arguments
(credentials, project, endpoint), as in the JAX package.

:class:`FilesystemResolver` cannot be pickled; its
:meth:`~FilesystemResolver.filesystem_factory` can, and rebuilds the
filesystem wherever it is called. :class:`RetryingFilesystemWrapper`
retries the idempotent calls (reads, listings, whole-object writes) under a
:class:`~petastorm_tpu_torch.retry.RetryPolicy`, with the ``fs-read-delay``
and ``fs-read-error`` fault sites in each attempt.

:func:`local_path` is for the few callers that need an operating-system
path (the native Parquet stage, ``mmap``, ``os`` calls): it raises for any
store that is not ``file``.
"""

from urllib.parse import urlparse

import fsspec


def normalize_dataset_url(dataset_url):
    """Accept both ``file:///path`` URLs and bare ``/path`` strings."""
    if not isinstance(dataset_url, str):
        raise ValueError('dataset_url must be a string, got {!r}'.format(type(dataset_url)))
    dataset_url = dataset_url.rstrip('/')
    if urlparse(dataset_url).scheme == '':
        if not dataset_url.startswith('/'):
            raise ValueError(
                'dataset_url {!r} has no scheme and is not an absolute path. '
                'Use e.g. file:///tmp/ds or gs://bucket/ds'.format(dataset_url))
        return 'file://' + dataset_url
    return dataset_url


def local_path(dataset_url):
    """``(normalized url, local filesystem path)``; raises ``ValueError``
    for a store that is not on the local disk, whose objects have no
    operating-system path."""
    url = normalize_dataset_url(dataset_url)
    parsed = urlparse(url)
    if parsed.scheme != 'file':
        raise ValueError('{!r} is not a local (file://) store: this operation needs an '
                         'operating-system path'.format(url))
    return url, parsed.path


class FilesystemResolver(object):
    """Resolves a dataset URL into an fsspec filesystem and in-fs path."""

    def __init__(self, dataset_url, storage_options=None):
        self._url = normalize_dataset_url(dataset_url)
        self._storage_options = dict(storage_options or {})
        parsed = urlparse(self._url)
        self._scheme = 'gs' if parsed.scheme == 'gcs' else parsed.scheme
        self._netloc = parsed.netloc
        if self._scheme == 'file':
            self._path = parsed.path
        elif self._scheme in ('hdfs', 'webhdfs'):
            # The netloc is the nameservice or namenode, not part of the path.
            self._path = parsed.path or '/'
        else:
            # Object stores keep the bucket in the path.
            self._path = (parsed.netloc + parsed.path if parsed.netloc
                          else parsed.path.lstrip('/'))
        self._fs = None

    @property
    def scheme(self):
        return self._scheme

    @property
    def dataset_url(self):
        return self._url

    def filesystem(self):
        if self._fs is None:
            self._fs = _build_filesystem(self._scheme, self._storage_options, self._netloc)
        return self._fs

    def get_dataset_path(self):
        return self._path

    def filesystem_factory(self):
        """A picklable zero-argument callable that rebuilds the filesystem."""
        return _FilesystemFactory(self._scheme, dict(self._storage_options), self._netloc)

    def __getstate__(self):
        raise RuntimeError('FilesystemResolver cannot be pickled; use filesystem_factory()')


def _build_filesystem(scheme, options, netloc=''):
    if scheme == 'hdfs':
        # A nameservice netloc gets namenode failover; host:port connects.
        from petastorm_tpu_torch.hdfs import connect_for_netloc
        return connect_for_netloc(netloc, options)
    if scheme == 'webhdfs' and netloc:
        host, _, port = netloc.partition(':')
        options = dict(options)
        options.setdefault('host', host)
        if port:
            options.setdefault('port', int(port))
    return fsspec.filesystem(scheme, **options)


class _FilesystemFactory(object):
    """Module-level (picklable) zero-argument filesystem constructor."""

    def __init__(self, scheme, options, netloc=''):
        self._scheme = scheme
        self._options = options
        self._netloc = netloc

    def __call__(self):
        return _build_filesystem(self._scheme, self._options, self._netloc)


class RetryingFilesystemWrapper(object):
    """Retries transient IO failures of a filesystem's idempotent calls
    (``petastorm_tpu/fs.py:128-212``).

    Only reads, listings and whole-object overwrites are retried
    (:attr:`RETRY_METHODS`): a mutation whose success is not repeatable
    (``rm``, ``mv``, ``mkdir``) could report a spurious failure after a
    server-side success with a lost response; ``extra_retry_methods`` opts
    such methods in. Each attempt passes the ``fs-read-delay`` and
    ``fs-read-error`` fault sites, keyed by the method's name.
    """

    RETRY_METHODS = frozenset((
        'open', 'ls', 'exists', 'isdir', 'isfile', 'info', 'glob', 'walk',
        'find', 'du', 'put', 'get', 'copy', 'cat_file', 'pipe_file',
        'created', 'modified', 'size',
    ))

    #: Cap on any single backoff sleep.
    MAX_BACKOFF_S = 2.0

    def __init__(self, fs, retries=2, retry_exceptions=(IOError, OSError), backoff_s=0.1,
                 on_retry=None, extra_retry_methods=(), retry_policy=None):
        """:param retries: extra attempts after the first failure.
        :param on_retry: optional ``f(method_name, attempt, exception)``.
        :param extra_retry_methods: more method names to retry.
        :param retry_policy: a :class:`~petastorm_tpu_torch.retry.
            RetryPolicy` that replaces ``retries``, ``retry_exceptions``
            and ``backoff_s``; the default one uses full-jitter backoff."""
        from petastorm_tpu_torch.retry import RetryPolicy

        self._fs = fs
        self._on_retry = on_retry
        self._retry_methods = self.RETRY_METHODS | frozenset(extra_retry_methods)
        if retry_policy is not None:
            self._policy = retry_policy
        else:
            self._policy = RetryPolicy(
                max_attempts=int(retries) + 1,
                base_delay_s=backoff_s or 0.0,
                # A backoff asked above the default cap stays reachable.
                max_delay_s=max(self.MAX_BACKOFF_S, backoff_s or 0.0),
                retry_exceptions=tuple(retry_exceptions),
                on_retry=self._policy_on_retry)

    def _policy_on_retry(self, name, attempt, exc, delay_s):
        if self._on_retry is not None:
            self._on_retry(name, attempt, exc)

    @property
    def wrapped(self):
        return self._fs

    @property
    def retry_policy(self):
        return self._policy

    def __getattr__(self, name):
        attr = getattr(self._fs, name)
        if name not in self._retry_methods or not callable(attr):
            return attr

        def attempt_once(*args, **kwargs):
            from petastorm_tpu_torch.faults import maybe_inject
            maybe_inject('fs-read-delay', key=name)
            maybe_inject('fs-read-error', key=name)
            return attr(*args, **kwargs)

        def call_with_retry(*args, **kwargs):
            kwargs['retry_call_name'] = name
            return self._policy.call(attempt_once, *args, **kwargs)

        return call_with_retry


def get_filesystem_and_path(url_or_path, storage_options=None, retries=None):
    """``url -> (fsspec filesystem, path)``; ``retries`` (an int) wraps the
    filesystem in :class:`RetryingFilesystemWrapper`."""
    resolver = FilesystemResolver(url_or_path, storage_options)
    fs = resolver.filesystem()
    if retries is not None:
        fs = RetryingFilesystemWrapper(fs, retries=retries)
    return fs, resolver.get_dataset_path()
