"""``dryrun_multigpu(4)`` on four gloo ranks: the claims of the JAX
package's ``__graft_entry__.dryrun_multichip`` (dp x tp ResNetTiny behind
the pod guard with a mid-epoch resume that loses and repeats no sample,
the HBM tier on the mesh for three epochs, and the LM on dp x sp x tp whose
ring and all-to-all trajectories agree and descend), asserted on every
rank by the dry run itself."""

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.parallel import dryrun
from petastorm_tpu_torch.parallel.launch import spawn


@pytest.mark.timeout(240)
def test_dryrun_multigpu_on_four_ranks(tmp_path):
    results = spawn(dryrun._spawned_rank, 4, (str(tmp_path),), timeout=200)
    for trajectories in results:
        assert len(trajectories['ring']) >= 3
        np.testing.assert_allclose(trajectories['ring'], trajectories['a2a'], rtol=1e-4,
                                   atol=1e-5)
    assert all(r == results[0] for r in results)


def test_dryrun_needs_a_group_of_its_size():
    with pytest.raises(RuntimeError, match='started process group'):
        dryrun.dryrun_multigpu(4, device='cpu')


@pytest.mark.skipif(torch.cuda.is_available(), reason='the default device is a GPU here')
def test_dryrun_defaults_to_the_gpu():
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        dryrun.dryrun_multigpu(4)
