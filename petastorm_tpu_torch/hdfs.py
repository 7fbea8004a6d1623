"""HDFS high availability: nameservice resolution and namenode failover.

Counterpart of ``petastorm_tpu/hdfs.py``. :class:`HdfsNamenodeResolver`
reads a nameservice's namenodes from the hadoop site XML (``hdfs-site.xml``
and ``core-site.xml`` under ``$HADOOP_HOME/etc/hadoop``, or a dict);
:class:`HANamenodeFilesystem` proxies an fsspec filesystem and, on a
connection-class error, reconnects to the next namenode round-robin and
retries under a :class:`~petastorm_tpu_torch.retry.RetryPolicy`, raising
:class:`MaxFailoversExceeded` past its budget. It pickles as its connector
and namenode list, and reconnects where it is unpickled.
:func:`connect_for_netloc` is what :mod:`~petastorm_tpu_torch.fs` routes an
``hdfs://`` URL through.
"""

import logging
import os
import xml.etree.ElementTree as ET
from urllib.parse import urlparse

logger = logging.getLogger(__name__)

#: Environment variables probed (in order) for a Hadoop installation
#: (reference namenode.py:44-48).
HADOOP_HOME_ENVS = ('HADOOP_HOME', 'HADOOP_PREFIX', 'HADOOP_INSTALL')


class HdfsConnectError(IOError):
    """No namenode in the list accepted a connection."""


class MaxFailoversExceeded(RuntimeError):
    """An HDFS call kept failing across the full failover budget."""

    def __init__(self, failed_exceptions, max_failover_attempts, func_name):
        self.failed_exceptions = failed_exceptions
        self.max_failover_attempts = max_failover_attempts
        self.__name__ = func_name
        super(MaxFailoversExceeded, self).__init__(
            'Failover attempts exceeded maximum ({}) for action "{}". '
            'Exceptions:\n{}'.format(max_failover_attempts, func_name,
                                     failed_exceptions))


class HdfsNamenodeResolver(object):
    """Resolves HDFS nameservices to their namenode host:port lists from
    hadoop configuration (``hdfs-site.xml`` + ``core-site.xml``)."""

    def __init__(self, hadoop_configuration=None):
        """:param hadoop_configuration: a dict of hadoop properties; when
        omitted, the first of ``HADOOP_HOME``/``HADOOP_PREFIX``/
        ``HADOOP_INSTALL`` pointing at an installation is consulted for
        ``etc/hadoop/{hdfs,core}-site.xml``."""
        self._hadoop_env = None
        self._hadoop_path = None
        if hadoop_configuration is None:
            hadoop_configuration = {}
            for env in HADOOP_HOME_ENVS:
                if env in os.environ:
                    self._hadoop_env = env
                    self._hadoop_path = os.environ[env]
                    for site in ('hdfs-site.xml', 'core-site.xml'):
                        self._load_site_xml(
                            os.path.join(self._hadoop_path, 'etc', 'hadoop', site),
                            hadoop_configuration)
                    break
            else:
                logger.warning(
                    'No HadoopConfiguration supplied and none of %s is set; '
                    'namenode resolution will find nothing', (HADOOP_HOME_ENVS,))
        self._config = hadoop_configuration

    @staticmethod
    def _load_site_xml(xml_path, into):
        try:
            root = ET.parse(xml_path).getroot()
        except (OSError, ET.ParseError) as e:
            logger.error('Unable to parse hadoop site XML at %s: %s', xml_path, e)
            return
        for prop in root.iter('property'):
            name, value = prop.find('name'), prop.find('value')
            if name is not None and value is not None:
                into[name.text] = value.text

    def resolve_hdfs_name_service(self, namespace):
        """Namenode ``host:port`` list for a nameservice, or ``None`` when the
        namespace is not a configured nameservice (it may be a plain host)."""
        namenodes = self._config.get('dfs.ha.namenodes.' + namespace)
        if not namenodes:
            return None
        urls = []
        for nn in namenodes.split(','):
            key = 'dfs.namenode.rpc-address.{}.{}'.format(namespace, nn.strip())
            address = self._config.get(key)
            if not address:
                raise RuntimeError(
                    'Failed to get property "{}" from hadoop configuration{}'
                    .format(key, ' ({} = {})'.format(self._hadoop_env, self._hadoop_path)
                            if self._hadoop_path else ''))
            urls.append(address)
        return urls

    def resolve_default_hdfs_service(self):
        """``(nameservice, [namenode, ...])`` from ``fs.defaultFS``."""
        default_fs = self._config.get('fs.defaultFS')
        if not default_fs:
            raise RuntimeError(
                'Failed to get property "fs.defaultFS" from hadoop configuration')
        nameservice = urlparse(default_fs).netloc
        namenodes = self.resolve_hdfs_name_service(nameservice)
        if namenodes is None:
            raise RuntimeError(
                'Unable to get namenodes for nameservice {!r} (from fs.defaultFS '
                '{!r})'.format(nameservice, default_fs))
        return nameservice, namenodes


class FsspecHdfsConnector(object):
    """Picklable default connector: ``host:port -> fsspec hdfs filesystem``."""

    def __init__(self, storage_options=None):
        self._options = dict(storage_options or {})

    def __call__(self, namenode):
        import fsspec
        parsed = urlparse('hdfs://' + namenode)
        return fsspec.filesystem('hdfs', host=parsed.hostname or 'default',
                                 port=parsed.port or 8020, **self._options)


class HANamenodeFilesystem(object):
    """fsspec-filesystem proxy that fails over between HA namenodes.

    Every public method call is attempted against the currently connected
    namenode; on a connection-class error the proxy reconnects to the *next*
    namenode (round-robin, so two failovers with two namenodes retries the
    original — reference ``namenode.py:151-186``) and retries, up to
    :attr:`MAX_FAILOVER_ATTEMPTS` failovers, then raises
    :class:`MaxFailoversExceeded`.
    """

    #: Extra attempts after the first failure (reference namenode.py:152).
    MAX_FAILOVER_ATTEMPTS = 2

    #: Backoff for the failover retry loop (``retry.RetryPolicy``): a
    #: flapping namenode pair must not be hammered in a tight loop, so each
    #: failover sleeps a full-jittered, capped exponential delay. The
    #: reference failed over with no delay at all (``namenode.py:146-238``).
    FAILOVER_BASE_DELAY_S = 0.05
    FAILOVER_MAX_DELAY_S = 1.0

    def __init__(self, connect_fn, namenodes, failover_exceptions=(IOError, OSError)):
        """:param connect_fn: picklable ``host:port -> filesystem`` callable.
        :param namenodes: list of ``host:port`` strings (typically 2).
        :param failover_exceptions: exception classes that trigger failover."""
        if not namenodes:
            raise ValueError('namenodes list must not be empty')
        # Protected names keep __getattr__ out of our own state.
        self._connect_fn = connect_fn
        self._namenodes = list(namenodes)
        self._failover_exceptions = tuple(failover_exceptions)
        self._index = -1
        self._fs = None
        self._connect_next()

    @property
    def current_namenode(self):
        return self._namenodes[self._index]

    def __reduce__(self):
        return self.__class__, (self._connect_fn, self._namenodes,
                                self._failover_exceptions)

    def _connect_next(self):
        """Connect to the next namenode in round-robin order; raises
        :class:`HdfsConnectError` when none accepts."""
        for i in range(1, len(self._namenodes) + 1):
            idx = (self._index + i) % len(self._namenodes)
            namenode = self._namenodes[idx]
            try:
                fs = self._connect_fn(namenode)
            except self._failover_exceptions as e:
                logger.debug('Connect to namenode %s failed: %s', namenode, e)
                continue
            self._index = idx
            self._fs = fs
            return
        raise HdfsConnectError('Unable to connect to any namenode of {}'
                               .format(self._namenodes))

    def _failover_policy(self, on_retry):
        from petastorm_tpu_torch.retry import RetryPolicy
        return RetryPolicy(max_attempts=self.MAX_FAILOVER_ATTEMPTS + 1,
                           base_delay_s=self.FAILOVER_BASE_DELAY_S,
                           max_delay_s=self.FAILOVER_MAX_DELAY_S,
                           retry_exceptions=self._failover_exceptions,
                           on_retry=on_retry)

    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)
        attr = getattr(self._fs, name)
        if not callable(attr):
            return attr

        def call_on_current(*args, **kwargs):
            # Re-resolve on self._fs: a failover may have swapped it.
            return getattr(self._fs, name)(*args, **kwargs)

        def call_with_failover(*args, **kwargs):
            failures = []

            def on_retry(label, attempt, exc, delay_s):
                failures.append(exc)
                logger.warning('HDFS %s() failed on %s (%s); failing over '
                               '(backoff %.3fs)', label, self.current_namenode,
                               exc, delay_s)
                self._connect_next()

            policy = self._failover_policy(on_retry)
            try:
                kwargs['retry_call_name'] = 'hdfs:{}'.format(name)
                return policy.call(call_on_current, *args, **kwargs)
            except HdfsConnectError:
                # _connect_next (run by the retry hook) found NO namenode
                # accepting connections — that is "cluster unreachable", not
                # "failover budget exhausted"; propagate it undisguised.
                raise
            except self._failover_exceptions as e:
                failures.append(e)
                raise MaxFailoversExceeded(failures, self.MAX_FAILOVER_ATTEMPTS,
                                           name)

        return call_with_failover


def connect_for_netloc(netloc, storage_options=None, hadoop_configuration=None):
    """Filesystem for an ``hdfs://`` URL's netloc — this is the hook
    :class:`petastorm_tpu_torch.fs.FilesystemResolver` routes hdfs through.

    * empty netloc (``hdfs:///...``): resolve ``fs.defaultFS`` -> HA wrapper
    * configured nameservice: resolve its namenodes -> HA wrapper
    * anything else: treat as a concrete ``host[:port]`` namenode (non-HA)
    """
    resolver = HdfsNamenodeResolver(hadoop_configuration)
    connector = FsspecHdfsConnector(storage_options)
    if not netloc:
        _, namenodes = resolver.resolve_default_hdfs_service()
    else:
        namenodes = resolver.resolve_hdfs_name_service(netloc)
    if namenodes:
        return HANamenodeFilesystem(connector, namenodes)
    return connector(netloc)


def connect_ha_hdfs(url, storage_options=None, hadoop_configuration=None):
    """``hdfs://nameservice/...`` (or ``hdfs:///...`` using ``fs.defaultFS``)
    -> :class:`HANamenodeFilesystem`; a plain ``hdfs://host:port/...`` URL
    falls back to a direct (non-HA) fsspec connection.

    Returns ``(filesystem, path)``.
    """
    parsed = urlparse(url)
    if parsed.scheme != 'hdfs':
        raise ValueError('connect_ha_hdfs expects an hdfs:// URL, got {!r}'.format(url))
    return (connect_for_netloc(parsed.netloc, storage_options, hadoop_configuration),
            parsed.path)
