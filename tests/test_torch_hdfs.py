"""HDFS high availability in the port, on mocks (no HDFS service is
reachable): the cases of ``tests/test_hdfs_ha.py`` driven against
``petastorm_tpu_torch.hdfs``, and the same failover traces as the JAX
package's for the same scripted namenodes."""

import pickle

import pytest

import petastorm_tpu.hdfs as jax_hdfs
import petastorm_tpu_torch.hdfs as hdfs_mod
from petastorm_tpu_torch.fs import FilesystemResolver
from petastorm_tpu_torch.hdfs import (HANamenodeFilesystem, HdfsConnectError,
                                      HdfsNamenodeResolver, MaxFailoversExceeded,
                                      connect_for_netloc, connect_ha_hdfs)

HDFS_SITE = """<?xml version="1.0"?>
<configuration>
  <property><name>dfs.ha.namenodes.ns1</name><value>nn1,nn2</value></property>
  <property><name>dfs.namenode.rpc-address.ns1.nn1</name><value>nnhost1:8020</value></property>
  <property><name>dfs.namenode.rpc-address.ns1.nn2</name><value>nnhost2:8020</value></property>
  <property><name>dfs.ha.namenodes.broken</name><value>nn1</value></property>
</configuration>
"""

CORE_SITE = """<?xml version="1.0"?>
<configuration>
  <property><name>fs.defaultFS</name><value>hdfs://ns1</value></property>
</configuration>
"""


@pytest.fixture
def hadoop_home(tmp_path, monkeypatch):
    conf = tmp_path / 'etc' / 'hadoop'
    conf.mkdir(parents=True)
    (conf / 'hdfs-site.xml').write_text(HDFS_SITE)
    (conf / 'core-site.xml').write_text(CORE_SITE)
    for env in ('HADOOP_PREFIX', 'HADOOP_INSTALL'):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv('HADOOP_HOME', str(tmp_path))
    return tmp_path


class _MockFs(object):
    """Filesystem stub; the per-namenode failure budget lives on the
    connector, so it survives reconnects (a standby namenode stays standby)."""

    def __init__(self, namenode, connector):
        self.namenode = namenode
        self.connector = connector
        self.readonly_attr = 'not-callable'

    def ls(self, path):
        remaining = self.connector.fail_calls_by_nn.get(self.namenode, 0)
        if remaining > 0:
            self.connector.fail_calls_by_nn[self.namenode] = remaining - 1
            raise IOError('standby namenode {}'.format(self.namenode))
        return ['{}:{}'.format(self.namenode, path)]


class _MockConnector(object):
    """Picklable connect factory with scriptable per-namenode behaviour."""

    def __init__(self, fail_calls_by_nn=None, refuse=()):
        self.fail_calls_by_nn = dict(fail_calls_by_nn or {})
        self.refuse = tuple(refuse)
        self.connects = []

    def __call__(self, namenode):
        self.connects.append(namenode)
        if namenode in self.refuse:
            raise IOError('connection refused: {}'.format(namenode))
        return _MockFs(namenode, self)


def _quiet(cls):
    """``cls`` whose failover policy does not sleep."""
    class Quiet(cls):
        def _failover_policy(self, on_retry):
            policy = super(Quiet, self)._failover_policy(on_retry)
            policy._sleep = lambda s: None
            return policy
    return Quiet


def test_resolve_nameservice_from_hadoop_home(hadoop_home):
    assert HdfsNamenodeResolver().resolve_hdfs_name_service('ns1') == \
        ['nnhost1:8020', 'nnhost2:8020']
    assert jax_hdfs.HdfsNamenodeResolver().resolve_hdfs_name_service('ns1') == \
        ['nnhost1:8020', 'nnhost2:8020']


def test_resolve_default_service(hadoop_home):
    assert HdfsNamenodeResolver().resolve_default_hdfs_service() == \
        ('ns1', ['nnhost1:8020', 'nnhost2:8020'])


def test_unknown_namespace_returns_none(hadoop_home):
    assert HdfsNamenodeResolver().resolve_hdfs_name_service('plainhost') is None


def test_missing_rpc_address_raises(hadoop_home):
    with pytest.raises(RuntimeError, match='dfs.namenode.rpc-address.broken.nn1'):
        HdfsNamenodeResolver().resolve_hdfs_name_service('broken')


def test_explicit_configuration_dict():
    config = {'dfs.ha.namenodes.x': 'a,b', 'dfs.namenode.rpc-address.x.a': 'h1:9000',
              'dfs.namenode.rpc-address.x.b': 'h2:9000'}
    assert HdfsNamenodeResolver(config).resolve_hdfs_name_service('x') == ['h1:9000', 'h2:9000']


def test_no_default_fs_raises():
    with pytest.raises(RuntimeError, match='fs.defaultFS'):
        HdfsNamenodeResolver({}).resolve_default_hdfs_service()


def test_connects_to_first_healthy_namenode():
    connector = _MockConnector(refuse=('nn-a:8020',))
    fs = HANamenodeFilesystem(connector, ['nn-a:8020', 'nn-b:8020'])
    assert fs.current_namenode == 'nn-b:8020'
    assert fs.ls('/x') == ['nn-b:8020:/x']


def test_no_namenode_reachable_raises():
    with pytest.raises(HdfsConnectError):
        HANamenodeFilesystem(_MockConnector(refuse=('a:1', 'b:1')), ['a:1', 'b:1'])
    with pytest.raises(ValueError):
        HANamenodeFilesystem(_MockConnector(), [])


def test_single_failover_on_standby_error():
    connector = _MockConnector(fail_calls_by_nn={'nn1:8020': 100})
    fs = _quiet(HANamenodeFilesystem)(connector, ['nn1:8020', 'nn2:8020'])
    assert fs.ls('/data') == ['nn2:8020:/data']
    assert connector.connects == ['nn1:8020', 'nn2:8020']


def test_round_robin_returns_to_original():
    connector = _MockConnector(fail_calls_by_nn={'nn1:8020': 1, 'nn2:8020': 100})
    fs = _quiet(HANamenodeFilesystem)(connector, ['nn1:8020', 'nn2:8020'])
    assert fs.ls('/d') == ['nn1:8020:/d']
    assert connector.connects == ['nn1:8020', 'nn2:8020', 'nn1:8020']


def test_max_failovers_exceeded():
    connector = _MockConnector(fail_calls_by_nn={'a:1': 100, 'b:1': 100})
    fs = _quiet(HANamenodeFilesystem)(connector, ['a:1', 'b:1'])
    with pytest.raises(MaxFailoversExceeded) as exc_info:
        fs.ls('/d')
    assert len(exc_info.value.failed_exceptions) == HANamenodeFilesystem.MAX_FAILOVER_ATTEMPTS + 1
    assert exc_info.value.__name__ == 'ls'


@pytest.mark.parametrize('script', [
    ({'nn1:1': 100}, ()), ({'nn1:1': 1, 'nn2:1': 100}, ()), ({'nn1:1': 100, 'nn2:1': 100}, ()),
    ({}, ('nn1:1',)), ({'nn2:1': 3}, ('nn1:1',)), ({'nn1:1': 2, 'nn2:1': 1, 'nn3:1': 5}, ()),
], ids=['standby', 'back-to-original', 'exhausted', 'refused', 'refused-then-standby',
        'three-namenodes'])
def test_failover_traces_equal_the_jax_packages(script):
    """The same scripted namenodes give the same answers, connect orders and
    failure counts through both packages' proxies."""
    traces = []
    for cls in (HANamenodeFilesystem, jax_hdfs.HANamenodeFilesystem):
        connector = _MockConnector(fail_calls_by_nn=script[0], refuse=script[1])
        fs = _quiet(cls)(connector, ['nn1:1', 'nn2:1', 'nn3:1'] if len(script[0]) == 3
                         else ['nn1:1', 'nn2:1'])
        answers = []
        for path in ('/a', '/b'):
            try:
                answers.append(fs.ls(path))
            except Exception as e:  # noqa: BLE001 - the outcome compared
                answers.append((type(e).__name__, len(getattr(e, 'failed_exceptions', ()))))
        traces.append((answers, connector.connects, fs.current_namenode))
    assert traces[0] == traces[1]


def test_non_callable_attributes_pass_through():
    fs = HANamenodeFilesystem(_MockConnector(), ['nn:1'])
    assert fs.readonly_attr == 'not-callable'
    with pytest.raises(AttributeError):
        fs._private_thing


def test_pickle_reconnects():
    fs = HANamenodeFilesystem(_MockConnector(), ['nn-a:1', 'nn-b:1'])
    clone = pickle.loads(pickle.dumps(fs))
    assert clone.ls('/p') == ['nn-a:1:/p']


def test_connect_ha_hdfs_resolves_nameservice(hadoop_home, monkeypatch):
    monkeypatch.setattr(hdfs_mod, 'FsspecHdfsConnector',
                        lambda storage_options=None: _MockConnector())
    fs, path = connect_ha_hdfs('hdfs://ns1/user/data')
    assert isinstance(fs, HANamenodeFilesystem)
    assert path == '/user/data'
    assert fs.ls('/q') == ['nnhost1:8020:/q']
    default = connect_for_netloc('')
    assert isinstance(default, HANamenodeFilesystem)
    assert default.current_namenode == 'nnhost1:8020'


def test_connect_for_a_plain_host_is_direct(hadoop_home, monkeypatch):
    monkeypatch.setattr(hdfs_mod, 'FsspecHdfsConnector',
                        lambda storage_options=None: _MockConnector())
    fs = connect_for_netloc('plainhost:9000')
    assert isinstance(fs, _MockFs) and fs.namenode == 'plainhost:9000'


def test_connect_ha_hdfs_rejects_other_schemes():
    with pytest.raises(ValueError, match='hdfs://'):
        connect_ha_hdfs('gs://bucket/x')


def test_filesystem_resolver_routes_hdfs_through_ha(hadoop_home, monkeypatch):
    monkeypatch.setattr(hdfs_mod, 'FsspecHdfsConnector',
                        lambda storage_options=None: _MockConnector())
    resolver = FilesystemResolver('hdfs://ns1/user/data')
    assert isinstance(resolver.filesystem(), HANamenodeFilesystem)
    assert resolver.get_dataset_path() == '/user/data'
    clone_fs = pickle.loads(pickle.dumps(resolver.filesystem_factory()))()
    assert isinstance(clone_fs, HANamenodeFilesystem)
