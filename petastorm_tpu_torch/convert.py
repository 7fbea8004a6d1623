"""Flax ResNet and TransformerLM weights -> the port's ``state_dict``s.

Takes numpy trees as ``flax.traverse_util.flatten_dict`` gives them (keys
are tuples of path names) and imports no flax. Layouts: conv kernels
HWIO -> OIHW, dense kernels ``[in, out]`` -> ``[out, in]``; BatchNorm
``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
``running_mean``/``running_var``. Flax names blocks ``<BlockClass>_<i>`` and
their layers ``Conv_<k>``/``BatchNorm_<k>`` plus ``conv_proj``/``norm_proj``.
TransformerLM: ``DenseGeneral`` q/k/v kernels ``[d, H, Dh]`` (bias ``[H, Dh]``)
and the ``out`` kernel ``[H, Dh, d]`` flatten to ``[d, H*Dh]`` and
``[H*Dh, d]`` before the transpose; embeddings keep their layout.
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


_LM_LAYERS = {'Embed_0': 'embed', 'pos_embed': 'pos_embed', 'LayerNorm_0': 'norm', 'head': 'head'}
_LM_BLOCK_LAYERS = {'LayerNorm_0': 'norm_attn', 'LayerNorm_1': 'norm_mlp', 'Dense_0': 'mlp_in',
                    'Dense_1': 'mlp_out', 'attn/query': 'attn.query', 'attn/key': 'attn.key',
                    'attn/value': 'attn.value', 'attn/out': 'attn.out'}
_LM_LEAF = {'embedding': 'weight', 'kernel': 'weight', 'bias': 'bias', 'scale': 'scale'}


def transformer_params_from_flax(params):
    """``state_dict`` for :class:`petastorm_tpu_torch.models.transformer.
    TransformerLM` from flattened flax ``params``."""
    state = {}
    for path, value in params.items():
        value = np.asarray(value, dtype=np.float32)
        m = re.fullmatch(r'block_(\d+)', path[0])
        layer = '/'.join(path[1:-1]) if m else '/'.join(path[:-1])
        table = _LM_BLOCK_LAYERS if m else _LM_LAYERS
        leaf = path[-1]
        if layer not in table or leaf not in _LM_LEAF:
            raise KeyError('unexpected flax param {}'.format('/'.join(path)))
        module = ('blocks.{}.'.format(m.group(1)) if m else '') + table[layer]
        if leaf == 'kernel':
            if layer == 'attn/out':
                value = value.reshape(-1, value.shape[-1])
            value = value.reshape(value.shape[0], -1).T
        elif leaf == 'bias':
            value = value.reshape(-1)
        state['{}.{}'.format(module, _LM_LEAF[leaf])] = torch.from_numpy(value.copy())
    return state


def load_flax_transformer(model, params):
    """Load flax weights into ``model``; every tensor must be covered."""
    missing, unexpected = model.load_state_dict(transformer_params_from_flax(params), strict=False)
    if missing or unexpected:
        raise KeyError('flax/torch TransformerLM mismatch: missing {}, unexpected {}'.format(
            missing, unexpected))
    return model
