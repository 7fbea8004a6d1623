"""Flax ResNet weights -> the port's ResNet ``state_dict``.

Takes numpy trees as ``flax.traverse_util.flatten_dict`` gives them (keys
are tuples of path names) and imports no flax. Layouts: conv kernels
HWIO -> OIHW, dense kernels ``[in, out]`` -> ``[out, in]``; BatchNorm
``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
``running_mean``/``running_var``. Flax names blocks ``<BlockClass>_<i>`` and
their layers ``Conv_<k>``/``BatchNorm_<k>`` plus ``conv_proj``/``norm_proj``.
"""

import re

import numpy as np
import torch

_BN_PARAM = {'scale': 'weight', 'bias': 'bias'}
_BN_STAT = {'mean': 'running_mean', 'var': 'running_var'}


def _module_name(path):
    """Torch module path of a flax module path (tuple of names)."""
    parts = []
    for name in path:
        m = re.fullmatch(r'(?:BottleneckBlock|ResNetBlock)_(\d+)', name)
        if m:
            parts.append('blocks.{}'.format(m.group(1)))
            continue
        m = re.fullmatch(r'(Conv|BatchNorm)_(\d+)', name)
        if m:
            parts.append(('conv' if m.group(1) == 'Conv' else 'norm') + m.group(2))
            continue
        parts.append(name)
    return '.'.join(parts)


def resnet_params_from_flax(params, batch_stats=None):
    """``state_dict`` for :class:`petastorm_tpu_torch.models.resnet.ResNet`
    from flattened flax ``params`` (and ``batch_stats``)."""
    state = {}
    for path, value in params.items():
        value = np.asarray(value, dtype=np.float32)
        module, leaf = _module_name(path[:-1]), path[-1]
        if leaf == 'kernel' and value.ndim == 4:
            state[module + '.weight'] = torch.from_numpy(value.transpose(3, 2, 0, 1).copy())
        elif leaf == 'kernel' and value.ndim == 2:
            state[module + '.weight'] = torch.from_numpy(value.T.copy())
        elif module == 'head' and leaf == 'bias':
            state[module + '.bias'] = torch.from_numpy(value.copy())
        elif leaf in _BN_PARAM:
            state['{}.{}'.format(module, _BN_PARAM[leaf])] = torch.from_numpy(value.copy())
        else:
            raise KeyError('unexpected flax param {}'.format('/'.join(path)))
    for path, value in (batch_stats or {}).items():
        module, leaf = _module_name(path[:-1]), path[-1]
        if leaf not in _BN_STAT:
            raise KeyError('unexpected flax batch stat {}'.format('/'.join(path)))
        state['{}.{}'.format(module, _BN_STAT[leaf])] = torch.from_numpy(
            np.asarray(value, dtype=np.float32).copy())
    return state


def load_flax_resnet(model, params, batch_stats=None):
    """Load flax weights into ``model``; every tensor must be covered
    (``num_batches_tracked`` counters excepted)."""
    state = resnet_params_from_flax(params, batch_stats)
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith('num_batches_tracked')]
    if missing or unexpected:
        raise KeyError('flax/torch ResNet mismatch: missing {}, unexpected {}'.format(
            missing, unexpected))
    return model
