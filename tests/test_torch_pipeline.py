"""``pipeline_apply`` of the port on two gloo ranks (the GPipe schedule over
P2P, its backward written out), held against the JAX package's on a
2-stage virtual mesh and against applying the stages one after another.

A tanh MLP stage with a stage-stacked weight and bias and a shared scalar
leaf (which stays whole on every stage), 4 and 8 microbatches of a batch
of 16, f32: the output ``atol=rtol=1e-5``, the gradients of ``sum(out *
g)`` in the input and in every leaf ``atol=1e-5, rtol=1e-4``. One spawned
pair serves every case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks
from petastorm_tpu.models.pipeline import pipeline_apply as jax_pipeline_apply
from petastorm_tpu.parallel import make_mesh as jax_make_mesh
from petastorm_tpu_torch.models.pipeline import pipeline_param_spec
from petastorm_tpu_torch.parallel.launch import spawn

STAGES, D, BATCH = 2, 8, 16
MICROBATCHES = (4, 8)


def _inputs():
    rng = np.random.default_rng(11)
    params = {'w': (rng.standard_normal((STAGES, D, D)) / np.sqrt(D)).astype(np.float32),
              'b': (rng.standard_normal((STAGES, D)) * 0.1).astype(np.float32),
              'scale': np.asarray(1.5, np.float32)}
    x = rng.standard_normal((BATCH, D)).astype(np.float32)
    g = rng.standard_normal((BATCH, D)).astype(np.float32)
    return params, x, g


def _jax_stage(p, h):
    return jnp.tanh(h @ p['w'] + p['b']) * p['scale']


def _jax(params, x, g, microbatches):
    mesh = jax_make_mesh({'pipe': STAGES}, devices=jax.devices()[:STAGES])

    @jax.jit
    def run(params, x):
        out, vjp = jax.vjp(lambda p, x: jax_pipeline_apply(
            _jax_stage, p, x, mesh, microbatches=microbatches), params, x)
        return out, vjp(jnp.asarray(g))

    out, (dp, dx) = run({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return np.asarray(out), np.asarray(dx), {k: np.asarray(v) for k, v in dp.items()}


def _sequential(params, x, g):
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    h = xt
    for i in range(STAGES):
        h = torch.tanh(h @ p['w'][i] + p['b'][i]) * p['scale']
    (h * torch.from_numpy(g)).sum().backward()
    return (h.detach().numpy(), xt.grad.numpy(), {k: v.grad.numpy() for k, v in p.items()})


@pytest.fixture(scope='module')
def runs():
    params, x, g = _inputs()
    return params, x, g, spawn(torch_mesh_ranks.pipeline_cases, STAGES,
                               (params, x, g, MICROBATCHES), timeout=90)


@pytest.mark.timeout(200)
@pytest.mark.parametrize('microbatches', MICROBATCHES)
def test_pipeline_matches_jax_and_sequential(runs, microbatches):
    params, x, g, results = runs
    for want in (_jax(params, x, g, microbatches), _sequential(params, x, g)):
        want_out, want_dx, want_dp = want
        for res in results:
            got = res[microbatches]
            np.testing.assert_allclose(got['out'], want_out, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got['dx'], want_dx, rtol=1e-4, atol=1e-5)
            for name, value in want_dp.items():
                np.testing.assert_allclose(got['grads'][name], value, rtol=1e-4, atol=1e-5,
                                           err_msg=name)


@pytest.mark.timeout(200)
def test_batch_not_divisible_raises(runs):
    for res in runs[3]:
        assert 'not divisible into 2 microbatches' in res['indivisible']


class _Mesh(object):
    mesh_dim_names = ('pipe', 'data')

    def size(self, dim):
        return (STAGES, 1)[dim]


def test_param_spec_splits_stage_stacked_leaves_only():
    mesh = _Mesh()
    assert pipeline_param_spec('w', torch.empty(STAGES, D, D), mesh) == ('pipe', None, None)
    assert pipeline_param_spec('b', torch.empty(3, D), mesh) is None
    assert pipeline_param_spec('scale', torch.empty(()), mesh) is None
    assert pipeline_param_spec('w', torch.empty(STAGES, D), None) is None
