"""Flax ResNet, TransformerLM, ViT and MLP weights -> the port's ``state_dict``s.

Takes numpy trees as ``flax.traverse_util.flatten_dict`` gives them (keys
are tuples of path names) and imports no flax. Layouts: conv kernels
HWIO -> OIHW, dense kernels ``[in, out]`` -> ``[out, in]``; BatchNorm
``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
``running_mean``/``running_var``. Flax names blocks ``<BlockClass>_<i>`` and
their layers ``Conv_<k>``/``BatchNorm_<k>`` plus ``conv_proj``/``norm_proj``.
TransformerLM and ViT blocks: ``DenseGeneral`` q/k/v kernels ``[d, H, Dh]``
(bias ``[H, Dh]``) and the ``out`` kernel ``[H, Dh, d]`` flatten to
``[d, H*Dh]`` and ``[H*Dh, d]`` before the transpose; a ``SwitchMoE``'s
router is a dense layer and its expert weights keep flax's layout;
embeddings keep their layout. Every converter is strict: a flax param it
does not know raises, and a ``load_*`` raises on any tensor left uncovered.
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
_VIT_LAYERS = {'patch_embed': 'patch_embed', 'LayerNorm_0': 'norm', 'head': 'head'}
_VIT_PARAMS = ('cls', 'pos_embed')
_LM_BLOCK_LAYERS = {'LayerNorm_0': 'norm_attn', 'LayerNorm_1': 'norm_mlp', 'Dense_0': 'mlp_in',
                    'Dense_1': 'mlp_out', 'attn/query': 'attn.query', 'attn/key': 'attn.key',
                    'attn/value': 'attn.value', 'attn/out': 'attn.out',
                    'moe/router': 'moe.router'}
_LM_LEAF = {'embedding': 'weight', 'kernel': 'weight', 'bias': 'bias', 'scale': 'scale'}
_EXPERT_WEIGHTS = ('w_up', 'w_down')
#: Kernels whose output features are the last axis and whose input is every
#: axis before it (``out`` ``[H, Dh, d]``, the patch conv ``[p, p, C, d]``);
#: the others take their input on the first axis (``[d, H, Dh]``, ``[in, out]``).
_INPUT_LEADING = ('attn/out', 'patch_embed')


def _stack_params_from_flax(params, top_layers, top_params=()):
    """``state_dict`` entries of a stack of ``block_<i>`` Transformer blocks
    (dense or Switch-MoE MLPs) and the top-level layers ``top_layers``
    (flax name -> torch module) and params ``top_params`` (kept as they
    are). Raises ``KeyError`` on any other flax param."""
    state = {}
    for path, value in params.items():
        value = np.asarray(value, dtype=np.float32)
        m = re.fullmatch(r'block_(\d+)', path[0])
        layer = '/'.join(path[1:-1]) if m else '/'.join(path[:-1])
        prefix = 'blocks.{}.'.format(m.group(1)) if m else ''
        table = _LM_BLOCK_LAYERS if m else top_layers
        leaf = path[-1]
        if not m and len(path) == 1 and leaf in top_params:
            name = leaf
        elif m and layer == 'moe' and leaf in _EXPERT_WEIGHTS:
            name = prefix + 'moe.' + leaf                # flax's [E, d, h] / [E, h, d]
        elif layer in table and leaf in _LM_LEAF:
            name = '{}{}.{}'.format(prefix, table[layer], _LM_LEAF[leaf])
            if leaf == 'kernel':
                if layer in _INPUT_LEADING:
                    value = value.reshape(-1, value.shape[-1]).T
                else:
                    value = value.reshape(value.shape[0], -1).T
            elif leaf == 'bias':
                value = value.reshape(-1)
        else:
            raise KeyError('unexpected flax param {}'.format('/'.join(path)))
        state[name] = torch.from_numpy(value.copy())
    return state


def _load_strict(model, state, what):
    missing, unexpected = model.load_state_dict(state, strict=False)
    if missing or unexpected:
        raise KeyError('flax/torch {} mismatch: missing {}, unexpected {}'.format(
            what, missing, unexpected))
    return model


def transformer_params_from_flax(params):
    """``state_dict`` for :class:`petastorm_tpu_torch.models.transformer.
    TransformerLM` (with or without ``SwitchMoE`` blocks) from flattened
    flax ``params``."""
    return _stack_params_from_flax(params, _LM_LAYERS)


def load_flax_transformer(model, params):
    """Load flax weights into ``model``; every tensor must be covered."""
    return _load_strict(model, transformer_params_from_flax(params), 'TransformerLM')


def vit_params_from_flax(params):
    """``state_dict`` for :class:`petastorm_tpu_torch.models.vit.ViT` from
    flattened flax ``params``: the patch conv's HWIO ``[p, p, C, d]``
    kernel becomes the patch Dense's ``[d, p·p·C]``; ``cls`` and
    ``pos_embed`` keep their layout."""
    return _stack_params_from_flax(params, _VIT_LAYERS, _VIT_PARAMS)


def load_flax_vit(model, params):
    """Load flax weights into ``model``; every tensor must be covered, and
    the flax ``pos_embed`` must be sized for the model's number of patches."""
    state = vit_params_from_flax(params)
    pos = state.get('pos_embed')
    if pos is not None and pos.shape[1] != model.num_patches + 1:
        raise ValueError('flax pos_embed holds {} positions; the ViT was built for {} patches '
                         '+ CLS'.format(pos.shape[1], model.num_patches))
    return _load_strict(model, state, 'ViT')


def mlp_params_from_flax(params):
    """``state_dict`` for :class:`petastorm_tpu_torch.models.mlp.MLP` from
    flattened flax ``params`` (``Dense_<i>`` -> ``layers.<i>``)."""
    state = {}
    for path, value in params.items():
        value = np.asarray(value, dtype=np.float32)
        m = re.fullmatch(r'Dense_(\d+)', path[0])
        if not m or len(path) != 2 or path[1] not in ('kernel', 'bias'):
            raise KeyError('unexpected flax param {}'.format('/'.join(path)))
        leaf = 'weight' if path[1] == 'kernel' else 'bias'
        state['layers.{}.{}'.format(m.group(1), leaf)] = torch.from_numpy(
            (value.T if leaf == 'weight' else value).copy())
    return state


def load_flax_mlp(model, params):
    """Load flax weights into ``model``; every tensor must be covered."""
    return _load_strict(model, mlp_params_from_flax(params), 'MLP')


def sharded_state_from_flax(model, load_fn, *trees, mesh, param_spec_fn=None, batch_axis='data',
                            **state_kwargs):
    """A mesh ``TrainState`` of ``model`` holding this rank's shards of a flax
    tree: ``load_fn(model, *trees)`` (e.g. :func:`load_flax_transformer`)
    loads the whole tree on every rank, then
    :func:`~petastorm_tpu_torch.models.train.create_train_state` keeps each
    rank's shard under ``param_spec_fn``. Every rank passes the same numpy
    arrays, as every JAX host places the same tree."""
    from petastorm_tpu_torch.models.train import create_train_state
    load_fn(model, *trees)
    return create_train_state(model, mesh=mesh, param_spec_fn=param_spec_fn,
                              batch_axis=batch_axis, **state_kwargs)
