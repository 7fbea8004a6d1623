"""The port's CUDA build and route choice, on the CPU (no nvcc, no card):
a library is rebuilt when any file under ``csrc/`` changes, every entry
point the wrappers bind is a C function of its source, and the flash
wrappers send each dtype and head dim to the kernels that take it."""

import contextlib
import os
import re

import pytest
import torch

from petastorm_tpu_torch.ops import _cuda_build
from petastorm_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    root = tmp_path / 'csrc'
    root.mkdir()
    (root / 'kernels.cu').write_text('#include "common.cuh"\n__global__ void k() {}\n')
    (root / 'common.cuh').write_text('#pragma once\nconstexpr int TILE = 64;\n')
    monkeypatch.setattr(_cuda_build, 'CSRC', str(root))
    monkeypatch.setattr(_cuda_build, 'BUILD_ROOT', str(tmp_path / 'build'))
    return root


def test_library_path_is_stable_and_named_after_the_source(csrc):
    path = _cuda_build.library_path('kernels.cu')
    assert path == _cuda_build.library_path('kernels.cu')
    assert os.path.basename(path) == 'libkernels.so'
    assert path.startswith(_cuda_build.BUILD_ROOT)


@pytest.mark.parametrize('edit', ['source', 'included header', 'new header'])
def test_library_path_changes_when_csrc_changes(csrc, edit):
    before = _cuda_build.library_path('kernels.cu')
    if edit == 'source':
        (csrc / 'kernels.cu').write_text('#include "common.cuh"\n__global__ void k2() {}\n')
    elif edit == 'included header':
        (csrc / 'common.cuh').write_text('#pragma once\nconstexpr int TILE = 128;\n')
    else:
        (csrc / 'sub').mkdir()
        (csrc / 'sub' / 'extra.cuh').write_text('#pragma once\n')
    assert _cuda_build.library_path('kernels.cu') != before


def test_library_path_changes_with_the_flags(csrc, monkeypatch):
    before = _cuda_build.library_path('kernels.cu')
    monkeypatch.setattr(_cuda_build, 'FLAGS', _cuda_build.FLAGS + ('-lineinfo',))
    assert _cuda_build.library_path('kernels.cu') != before


def test_two_sources_build_to_two_libraries(csrc):
    (csrc / 'other.cu').write_text('__global__ void o() {}\n')
    assert (os.path.dirname(_cuda_build.library_path('kernels.cu'))
            != os.path.dirname(_cuda_build.library_path('other.cu')))


def test_both_flash_sources_are_in_the_package():
    for source in (fa._SOURCE, fa._SM90_SOURCE):
        assert os.path.isfile(os.path.join(_cuda_build.CSRC, source))


@pytest.mark.parametrize('dtype,head_dim,route', [
    (torch.bfloat16, 64, 'cuda-sm90'),
    (torch.bfloat16, 128, 'cuda-sm90'),
    (torch.float32, 64, 'cuda'),
    (torch.float32, 128, 'cuda'),
    (torch.bfloat16, 16, 'cuda'),
    (torch.bfloat16, 4, 'cuda'),
    (torch.float32, 16, 'cuda'),
    (torch.float32, 4, 'cuda'),
    (torch.bfloat16, 96, 'cuda'),
])
def test_kernel_route_by_dtype_and_head_dim(dtype, head_dim, route):
    assert fa.kernel_route(dtype, head_dim) == route


def _extern_c_functions(source):
    """``{name: parameter count}`` of the functions in the ``extern "C"``
    block of ``csrc/<source>``."""
    with open(os.path.join(_cuda_build.CSRC, source)) as f:
        text = f.read()
    block = re.search(r'extern "C" \{(.*)\}\s*// extern "C"', text, re.S)
    assert block, 'no extern "C" block in {}'.format(source)
    return {name: len(params.split(','))
            for name, params in re.findall(r'^int (\w+)\(([^)]*)\)\s*\{', block.group(1), re.M)}


@pytest.mark.parametrize('source', sorted(fa._ARGTYPES))
def test_bound_entry_points_are_c_functions_of_their_source(source):
    """Each name ``_ARGTYPES`` binds is an ``extern "C"`` function of its
    source with as many parameters as it has argument types, so a name or
    signature that drifts fails here, before the card."""
    functions = _extern_c_functions(source)
    assert set(functions) == set(fa._ARGTYPES[source])
    for name, argtypes in fa._ARGTYPES[source].items():
        assert functions[name] == len(argtypes), name


class _StubLibrary:
    """Stands in for a kernel library: records each entry point called."""

    def __init__(self, calls, source):
        self._calls, self._source = calls, source

    def __getattr__(self, name):
        def entry(*args):
            self._calls.append((self._source, name, len(args)))
            return 0
        return entry


@pytest.mark.parametrize('dtype,head_dim,source,entry', [
    (torch.bfloat16, 64, fa._SM90_SOURCE, 'flash_dq_sm90'),
    (torch.bfloat16, 128, fa._SM90_SOURCE, 'flash_dq_sm90'),
    (torch.bfloat16, 32, fa._SOURCE, 'flash_dq'),
    (torch.float32, 64, fa._SOURCE, 'flash_dq'),
])
def test_flash_dq_picks_its_entry_point_by_route(monkeypatch, dtype, head_dim, source, entry):
    """No kernel runs: the libraries are stubs, the device checks are off."""
    calls = []
    monkeypatch.setattr(fa, '_library', lambda src=fa._SOURCE: _StubLibrary(calls, src))
    monkeypatch.setattr(fa, '_check_kernel_inputs', lambda *args: None)
    monkeypatch.setattr(fa, '_stream', lambda x: None)
    monkeypatch.setattr(torch.cuda, 'device', lambda device: contextlib.nullcontext())
    fa.reset_launch_counts()
    x = torch.zeros((2, 16, head_dim), dtype=dtype)
    row = torch.zeros((2, 16))
    dq = fa.flash_dq_cuda(x, x, x, x, row, row, 16, True)
    assert dq.shape == x.shape and dq.dtype == dtype
    assert calls == [(source, entry, len(fa._ARGTYPES[source][entry]))]
    assert fa.LAUNCHES == ({'flash_dq': 1, 'flash_dq_sm90': 1} if entry == 'flash_dq_sm90'
                           else {'flash_dq': 1})


def test_cpu_tensors_never_reach_a_kernel_route():
    """On the CPU the wrappers run the plain versions and count nothing,
    whatever route the dtype and head dim would take on the card."""
    fa.reset_launch_counts()
    q, k, v = (torch.randn((2, 64, 64)).to(torch.bfloat16) for _ in range(3))
    out, lse = fa.flash_fwd(q, k, v, 64, True, 64, True)
    assert out.dtype == torch.bfloat16 and lse.shape == (2, 64)
    assert sum(fa.LAUNCHES.values()) == 0
