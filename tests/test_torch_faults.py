"""Fault injection: the port's ``faults`` module against the JAX package's.
The same spec text parses alike, selects the same keys on a grid of seed,
site, key and ``p``, and spends ``max``, ``delay``, ``match`` and ``token``
budgets alike. The JAX side runs under its own variable and the port under
``PSTT_FAULTS``, each set through ``monkeypatch``."""

import itertools
import time

import pytest

from petastorm_tpu import faults as jax_faults
from petastorm_tpu.errors import DecodeFieldError as JaxDecodeFieldError
from petastorm_tpu_torch import faults
from petastorm_tpu_torch.errors import DecodeFieldError

SPECS = [
    'decode-corrupt:p=0.25:seed=9:max=3:delay=0.2',
    'fs-read-error:max=2',
    'fs-read-delay:delay=0.01;queue-stall:p=0.5:seed=3',
    'mem-pressure:match=results:bytes=512m',
    'mem-pressure:bytes=4096',
    'store-read-corrupt:p=1.0:seed=0;decode-corrupt-batch:match=part-00000',
    'worker-kill:token=/tmp/never-used-token',
    ' decode-corrupt : p=0.5 ; ; fs-read-error ',
]


def _spec_tuple(spec):
    return (spec.site, spec.p, spec.seed, spec.max_fires, spec.delay_s, spec.token, spec.match,
            spec.inflate_bytes)


def test_known_sites_are_the_jax_packages():
    assert faults.KNOWN_SITES == jax_faults.KNOWN_SITES
    assert faults._DELAY_SITES == jax_faults._DELAY_SITES
    assert faults.ENV_VAR == 'PSTT_FAULTS' != jax_faults.ENV_VAR


@pytest.mark.parametrize('text', SPECS)
def test_specs_parse_alike(text):
    port = faults.FaultInjector.from_string(text)
    jax = jax_faults.FaultInjector.from_string(text)
    assert port.active_sites == jax.active_sites
    for site in port.active_sites:
        assert _spec_tuple(port.spec(site)) == _spec_tuple(jax.spec(site))
        assert repr(port.spec(site)) == repr(jax.spec(site))


@pytest.mark.parametrize('text', ['', '   ', 'no-such-site', 'decode-corrupt:q=1',
                                  'decode-corrupt:p', 'fs-read-error:max=x', ':p=1'])
def test_bad_specs_fail_alike(text):
    outcomes = []
    for mod in (faults, jax_faults):
        try:
            outcomes.append(('ok', mod.FaultInjector.from_string(text).active_sites))
        except ValueError as e:
            outcomes.append(('ValueError', str(e).split('(')[0]))
    assert outcomes[0] == outcomes[1]


def test_selection_grid_equals_the_jax_packages():
    sites = ('decode-corrupt', 'fs-read-error', 'decode-corrupt-batch', 'store-read-corrupt')
    keys = ['part-00000-00000.parquet:{}'.format(i) for i in range(16)] + ['results-queue', None]
    differing, fired = [], 0
    for seed, site, p in itertools.product((0, 1, 7, 1234), sites, (0.0, 0.1, 0.5, 1.0)):
        text = '{}:p={}:seed={}'.format(site, p, seed)
        port = faults.FaultInjector.from_string(text)
        jax = jax_faults.FaultInjector.from_string(text)
        for key in keys:
            got = port.selected(site, key)
            fired += got
            if got != jax.selected(site, key):
                differing.append((text, key))
    assert not differing
    assert fired > 0


@pytest.mark.parametrize('path', ['/tmp/ds/part-00000-00000.parquet', 'bucket/x/a.parquet',
                                  '/pstt-imagenet/part-00000-00001.parquet', 'plain'])
@pytest.mark.parametrize('row_group', [0, 3, 17])
def test_rowgroup_fault_key_matches(path, row_group):
    key = faults.rowgroup_fault_key(path, row_group)
    assert key == jax_faults.rowgroup_fault_key(path, row_group)
    assert key.endswith(':{}'.format(row_group)) and '/' not in key


def _fires(mod, text, site, keys):
    injector = mod.FaultInjector.from_string(text)
    return [injector.should_fire(site, key) for key in keys]


@pytest.mark.parametrize('text,site,keys', [
    ('fs-read-error:max=2', 'fs-read-error', [None] * 5),
    ('fs-read-error:max=3:p=0.5:seed=4', 'fs-read-error', ['f:{}'.format(i) for i in range(12)]),
    ('queue-stall:p=0.3:seed=11', 'queue-stall', [None] * 40),
    ('decode-corrupt:match=part-00001', 'decode-corrupt',
     ['part-00000.parquet:1', 'part-00001.parquet:0', None, 'part-00001.parquet:5']),
    ('decode-corrupt:p=0.5:match=part', 'decode-corrupt', ['part:{}'.format(i) for i in range(8)]),
    ('decode-corrupt', 'fs-read-error', ['k']),
], ids=['max', 'max-and-p', 'keyless-stream', 'match', 'match-and-p', 'other-site'])
def test_fire_sequences_equal_the_jax_packages(text, site, keys):
    assert _fires(faults, text, site, keys) == _fires(jax_faults, text, site, keys)


def test_token_fires_once_across_injectors(tmp_path):
    token = tmp_path / 'token'
    text = 'fs-read-error:token={}'.format(token)
    first = faults.FaultInjector.from_string(text)
    second = faults.FaultInjector.from_string(text)
    assert first.should_fire('fs-read-error') and not second.should_fire('fs-read-error')
    assert not first.should_fire('fs-read-error')
    assert token.read_text().startswith('pid=')


def test_inject_effects_match(monkeypatch):
    slept = []
    monkeypatch.setattr(time, 'sleep', slept.append)
    for mod, error in ((faults, DecodeFieldError), (jax_faults, JaxDecodeFieldError)):
        injector = mod.FaultInjector.from_string(
            'decode-corrupt;fs-read-error;fs-read-delay:delay=0.25;device-put-delay:delay=0.5')
        with pytest.raises(error, match='injected fault: decode-corrupt'):
            injector.inject('decode-corrupt', key='a:1')
        with pytest.raises(IOError, match='injected fault: fs-read-error'):
            injector.inject('fs-read-error', key='a:1')
        injector.inject('fs-read-delay')
        injector.inject('device-put-delay')
        injector.inject('queue-stall')      # not armed: nothing
    assert slept == [0.25, 0.5, 0.25, 0.5]


def test_env_var_arms_and_reparses(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    assert not faults.faults_active()
    monkeypatch.setenv(faults.ENV_VAR, 'fs-read-error:max=1')
    assert faults.get_injector().active_sites == ['fs-read-error']
    with pytest.raises(IOError):
        faults.maybe_inject('fs-read-error', key='x:0')
    faults.maybe_inject('fs-read-error', key='x:0')     # max=1 spent
    monkeypatch.setenv(faults.ENV_VAR, 'queue-stall:delay=0')
    assert faults.get_injector().active_sites == ['queue-stall']
    # The JAX package's variable arms only the JAX package.
    monkeypatch.delenv(faults.ENV_VAR)
    monkeypatch.setenv(jax_faults.ENV_VAR, 'fs-read-error')
    assert not faults.faults_active()
    assert jax_faults.faults_active()


def test_mem_pressure_bytes_take_the_budgets_suffixes():
    assert faults.FaultSpec.parse('mem-pressure:bytes=512m').inflate_bytes == 512 * 1024 ** 2
    assert faults.FaultSpec.parse('mem-pressure:bytes=2g').inflate_bytes == \
        jax_faults.FaultSpec.parse('mem-pressure:bytes=2g').inflate_bytes
    assert faults.FaultSpec('mem-pressure', inflate_bytes=7).inflate_bytes == 7
    with pytest.raises(ValueError):
        faults.FaultSpec.parse('mem-pressure:bytes=lots')
