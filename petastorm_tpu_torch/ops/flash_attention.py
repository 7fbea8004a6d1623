"""Blocked (flash) attention, forward and backward, ``[B, T, H, D]``.

Counterpart of ``petastorm_tpu/ops/flash_attention.py``. On CUDA tensors
the three Pallas TPU kernels become hand-written CUDA C++ kernels for
Hopper (built by ``nvcc`` at first use, see :mod:`._cuda_build`):

- the forward replaces ``_flash_kernel`` (launched by ``_flash_bhtd``,
  ``flash_attention.py:115`` / ``:179``): out, and the logsumexp rows when
  a gradient will be needed;
- ``flash_dq`` replaces ``_flash_dq_kernel`` (``:232``) and dK/dV
  replaces ``_flash_dkv_kernel`` (``:270``), both launched by
  ``_flash_bwd_bhtd`` (``:316``).

Two routes, chosen by dtype and head dim only (:func:`kernel_route`):
bf16 with ``D`` in {64, 128} runs all three on
``csrc/flash_attention_sm90.cu`` (``flash_fwd_sm90``, ``flash_dq_sm90``,
``flash_dkv_sm90``: TMA, wgmma, register accumulators; route
``'cuda-sm90'``); f32 and every other head dim run on
``csrc/flash_attention.cu`` (``flash_fwd``, ``flash_dq``, ``flash_dkv``:
WMMA; route ``'cuda'``). Each source is its own library.

On CPU tensors the plain PyTorch versions below run instead
(:func:`flash_fwd_plain`, :func:`flash_dq_plain`, :func:`flash_dkv_plain`).
They repeat the kernels' arithmetic, casts included, and are what the
kernels are held against. There is no fallback between the two: a CUDA
tensor launches the kernel or raises.

Kept from the JAX package: the ``[B, T, H, D]`` interface, ``_pad_plan``
(power-of-two blocks, minimum 8, ``T`` padded to their lcm), the saved
residuals ``(q, k, v, out, lse)``, lse written only when a gradient is
needed, and ``D = rowsum(dO * O)`` as plain tensor ops outside every
kernel. Changed: lse is ``[BH, T_pad]`` f32 (the TPU's 128-lane broadcast
was a Mosaic layout), and the default blocks are 64x64, the CUDA kernels'
bf16 tiles (the JAX defaults, 512x1024, are TPU VMEM sizes). On the card
``block_q``/``block_k`` set only the padding plan; the kernels tile with
their own sizes (WMMA: 64x64 in bf16, 32x32 in f32; sm90: 128-row q tiles
against 128 kv rows in the forward and 64 in dQ, 128-row kv tiles against
64 q rows in dK/dV) and mask by ``seq_len``, so the result is the same
function.
"""

import collections
import ctypes
import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30          # large-finite, as the TPU kernels: -inf breaks the rescale
DEFAULT_BLOCK = 64
MAX_HEAD_DIM = 128

#: Kernel launches per kernel (incremented where each is launched, nowhere
#: else): the proof that a run went through the kernels. ``flash_fwd``,
#: ``flash_dq`` and ``flash_dkv`` count every launch of either route;
#: ``flash_fwd_sm90``, ``flash_dq_sm90`` and ``flash_dkv_sm90`` count the
#: Hopper route's.
LAUNCHES = collections.Counter()

#: Head dims the Hopper route (bf16 only) takes.
SM90_HEAD_DIMS = (64, 128)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = 'flash_attention.cu'
_SM90_SOURCE = 'flash_attention_sm90.cu'
_libs = {}


def reset_launch_counts():
    LAUNCHES.clear()


def _pad_plan(t, block_q, block_k):
    """(block_q, block_k, t_pad): blocks clamped to ``t`` and rounded down
    to powers of two (min 8), ``t`` padded to a multiple of both. Power-of-two
    blocks keep the lcm equal to the larger block, so padding stays below
    one block for any ``t`` (ring attention will hand arbitrary lengths)."""
    def _pow2_floor(b):
        return 1 << (b.bit_length() - 1)

    block_q = max(8, _pow2_floor(min(block_q, t)))
    block_k = max(8, _pow2_floor(min(block_k, t)))
    lcm = block_q * block_k // math.gcd(block_q, block_k)
    return block_q, block_k, -(-t // lcm) * lcm


def _to_bhtd(x, t_pad):
    """[B, T, H, D] -> padded contiguous [B*H, T_pad, D]."""
    b, t, h, d = x.shape
    x = x.permute(0, 2, 1, 3).reshape(b * h, t, d)
    if t_pad != t:
        x = F.pad(x, (0, 0, 0, t_pad - t))
    return x.contiguous()


def _from_bhtd(x, b, h, t):
    return x[:, :t].reshape(b, h, t, x.shape[-1]).permute(0, 2, 1, 3)


def _mask(q0, nq, k0, nk, seq_len, causal, device):
    """[nq, nk] visibility: kv tail padding + causal triangle."""
    k_pos = torch.arange(k0, k0 + nk, device=device)
    mask = (k_pos < seq_len)[None, :]
    if causal:
        q_pos = torch.arange(q0, q0 + nq, device=device)
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    return mask


# --------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' yardstick)
# --------------------------------------------------------------------------

def _mm(a, b):
    """A native-type product accumulated in f32: the operands are exact in f32."""
    return torch.matmul(a.float(), b.float())


def flash_fwd_plain(q, k, v, seq_len, causal, block_k):
    """``[BH, T_pad, D]`` -> ``(out, lse [BH, T_pad] f32)``: the online
    softmax over kv tiles of ``block_k``, all q rows at once."""
    bh, t_pad, d = q.shape
    scale = 1.0 / math.sqrt(d)
    acc = torch.zeros((bh, t_pad, d), dtype=torch.float32, device=q.device)
    m = torch.full((bh, t_pad), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, t_pad), dtype=torch.float32, device=q.device)
    for k0 in range(0, t_pad, block_k):
        k_blk, v_blk = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        mask = _mask(0, t_pad, k0, k_blk.shape[1], seq_len, causal, q.device)
        s = torch.where(mask, _mm(q, k_blk.transpose(1, 2)) * scale, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        correction = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * correction + p.sum(-1)
        acc = acc * correction[..., None] + _mm(p.to(v.dtype), v_blk)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)                 # fully masked rows
    return (acc / l[..., None]).to(q.dtype), m + torch.log(l)


def _recompute_p(q_blk, k_blk, lse, mask, scale):
    """This tile's ``P = exp(S - lse)``, zero where masked."""
    s = _mm(q_blk, k_blk.transpose(1, 2)) * scale
    return torch.where(mask, torch.exp(s - lse[..., None]), 0.0)


def flash_dq_plain(q, k, v, dout, lse, dd, seq_len, causal, block_k):
    """dQ = scale * sum over kv tiles of dS K, dS = P (dO V^T - D)."""
    bh, t_pad, d = q.shape
    scale = 1.0 / math.sqrt(d)
    acc = torch.zeros((bh, t_pad, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, t_pad, block_k):
        k_blk, v_blk = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        mask = _mask(0, t_pad, k0, k_blk.shape[1], seq_len, causal, q.device)
        p = _recompute_p(q, k_blk, lse, mask, scale)
        ds = p * (_mm(dout, v_blk.transpose(1, 2)) - dd[..., None])
        acc = acc + scale * _mm(ds.to(k.dtype), k_blk)
    return acc.to(q.dtype)


def flash_dkv_plain(q, k, v, dout, lse, dd, seq_len, causal, block_q):
    """dV = sum over q tiles of P^T dO; dK = scale * sum of dS^T Q."""
    bh, t_pad, d = q.shape
    scale = 1.0 / math.sqrt(d)
    dk = torch.zeros((bh, t_pad, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((bh, t_pad, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, t_pad, block_q):
        q_blk, do_blk = q[:, q0:q0 + block_q], dout[:, q0:q0 + block_q]
        mask = _mask(q0, q_blk.shape[1], 0, t_pad, seq_len, causal, q.device)
        p = _recompute_p(q_blk, k, lse[:, q0:q0 + block_q], mask, scale)
        dv = dv + _mm(p.to(dout.dtype).transpose(1, 2), do_blk)
        ds = p * (_mm(do_blk, v.transpose(1, 2)) - dd[:, q0:q0 + block_q, None])
        dk = dk + scale * _mm(ds.to(q.dtype).transpose(1, 2), q_blk)
    return dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: Each library's entry points and their argument types.
_ARGTYPES = {
    _SOURCE: {
        'flash_fwd': [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
        'flash_dq': [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
        'flash_dkv': [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]},
    _SM90_SOURCE: {
        'flash_fwd_sm90': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
        'flash_dq_sm90': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
        'flash_dkv_sm90': [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
        'flash_sm90_smem_bytes': [_I, _I]},
}


def _library(source=_SOURCE):
    """The typed ``ctypes`` library of ``csrc/<source>``, built at first use."""
    if source not in _libs:
        from petastorm_tpu_torch.ops import _cuda_build
        lib = _cuda_build.load(source)
        for name, argtypes in _ARGTYPES[source].items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _libs[source] = lib
    return _libs[source]


def kernel_route(dtype, head_dim):
    """Which kernels a CUDA call runs: ``'cuda-sm90'`` (the Hopper forward,
    dQ and dK/dV) for bf16 with a head dim in :data:`SM90_HEAD_DIMS`, else
    ``'cuda'`` (the WMMA kernels)."""
    return 'cuda-sm90' if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS else 'cuda'


def _check_kernel_inputs(name, tensors, vectors=()):
    """Raise on what the kernels cannot take: ``tensors`` are ``[BH, T_pad,
    D]`` in one type (bf16 or f32), ``vectors`` ``[BH, T_pad]`` f32, all
    contiguous on one CUDA device."""
    ref = tensors[0]
    if ref.ndim != 3:
        raise ValueError('{} takes [BH, T_pad, D] tensors, got shape {}'.format(
            name, tuple(ref.shape)))
    if ref.dtype not in _DTYPE_CODE:
        raise TypeError('{} takes bfloat16 or float32, got {}'.format(name, ref.dtype))
    if ref.shape[-1] > MAX_HEAD_DIM:
        raise ValueError('{} takes head dim <= {}, got {}'.format(name, MAX_HEAD_DIM, ref.shape[-1]))
    for x in tensors:
        if x.dtype != ref.dtype:
            raise TypeError('{}: mixed types {} and {}'.format(name, ref.dtype, x.dtype))
        if x.shape != ref.shape:
            raise ValueError('{}: shapes {} and {} differ'.format(
                name, tuple(ref.shape), tuple(x.shape)))
    for x in vectors:
        if x.dtype != torch.float32 or tuple(x.shape) != tuple(ref.shape[:2]):
            raise ValueError('{}: lse and D must be [BH, T_pad] float32, got {} {}'.format(
                name, x.dtype, tuple(x.shape)))
    for x in tuple(tensors) + tuple(vectors):
        if x.device != ref.device or x.device.type != 'cuda':
            raise ValueError('{}: every input must lie on one CUDA device'.format(name))
        if not x.is_contiguous():
            raise ValueError('{} needs contiguous inputs'.format(name))
    if kernel_route(ref.dtype, ref.shape[-1]) == 'cuda-sm90':
        # TMA reads [BH, T_pad, D] and [BH, T_pad] through tensor maps.
        if any(x.data_ptr() % 16 for x in tuple(tensors) + tuple(vectors)):
            raise ValueError('{} needs 16-byte aligned inputs on the sm90 route'.format(name))
        if ref.shape[1] % 8:
            raise ValueError('{} needs T_pad a multiple of 8 on the sm90 route, got {}'.format(
                name, ref.shape[1]))


_HOST_ERRORS = {-1: 'cuTensorMapEncodeTiled was not found in libcuda.so.1',
                -2: 'a TMA tensor map could not be encoded', -3: 'unsupported head dim'}


def _raise_on(err, name):
    if err < 0:
        raise RuntimeError('{} kernel launch failed: {}'.format(name, _HOST_ERRORS.get(err, err)))
    if err != 0:
        raise RuntimeError('{} kernel launch failed: CUDA error {}'.format(name, err))


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(kernel, q, pointers, seq_len, causal):
    """Launch ``kernel`` (``'flash_fwd'``, ``'flash_dq'`` or ``'flash_dkv'``)
    on the route :func:`kernel_route` picks for ``q``: ``<kernel>_sm90`` of
    the Hopper library, or ``<kernel>`` of the WMMA library (which also
    takes the dtype code). Raises on a non-zero return; counts the launch."""
    bh, t_pad, d = q.shape
    sm90 = kernel_route(q.dtype, d) == 'cuda-sm90'
    name = kernel + '_sm90' if sm90 else kernel
    args = pointers + (bh, t_pad, d, seq_len, int(causal), 1.0 / math.sqrt(d), _stream(q))
    with torch.cuda.device(q.device):
        if sm90:
            err = getattr(_library(_SM90_SOURCE), name)(*args)
        else:
            err = getattr(_library(), name)(_DTYPE_CODE[q.dtype], *args)
    _raise_on(err, name)
    LAUNCHES[kernel] += 1
    if sm90:
        LAUNCHES[name] += 1


def flash_fwd_cuda(q, k, v, seq_len, causal, emit_lse):
    _check_kernel_inputs('flash_fwd', (q, k, v))
    bh, t_pad, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, t_pad), dtype=torch.float32, device=q.device) if emit_lse else None
    _launch('flash_fwd', q, (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             lse.data_ptr() if emit_lse else None), seq_len, causal)
    return out, lse


def flash_dq_cuda(q, k, v, dout, lse, dd, seq_len, causal):
    _check_kernel_inputs('flash_dq', (q, k, v, dout), (lse, dd))
    dq = torch.empty_like(q)
    _launch('flash_dq', q, (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                            lse.data_ptr(), dd.data_ptr(), dq.data_ptr()), seq_len, causal)
    return dq


def flash_dkv_cuda(q, k, v, dout, lse, dd, seq_len, causal):
    _check_kernel_inputs('flash_dkv', (q, k, v, dout), (lse, dd))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch('flash_dkv', q, (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                             lse.data_ptr(), dd.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            seq_len, causal)
    return dk, dv


# --------------------------------------------------------------------------
# dispatch by device, autograd, public entry
# --------------------------------------------------------------------------

def _on(x):
    if x.device.type not in ('cuda', 'cpu'):
        raise ValueError('flash_attention runs on cuda or cpu tensors, got {}'.format(x.device))
    return x.device.type


def flash_fwd(q, k, v, seq_len, causal, block_k, emit_lse):
    """Padded ``[BH, T_pad, D]`` -> ``(out, lse | None)``."""
    if _on(q) == 'cuda':
        return flash_fwd_cuda(q, k, v, seq_len, causal, emit_lse)
    out, lse = flash_fwd_plain(q, k, v, seq_len, causal, block_k)
    return out, (lse if emit_lse else None)


def flash_bwd(q, k, v, dout, lse, dd, seq_len, causal, block_q, block_k):
    """Padded ``[BH, T_pad, D]`` -> ``(dq, dk, dv)``."""
    if _on(q) == 'cuda':
        dq = flash_dq_cuda(q, k, v, dout, lse, dd, seq_len, causal)
        return (dq,) + flash_dkv_cuda(q, k, v, dout, lse, dd, seq_len, causal)
    dq = flash_dq_plain(q, k, v, dout, lse, dd, seq_len, causal, block_k)
    return (dq,) + flash_dkv_plain(q, k, v, dout, lse, dd, seq_len, causal, block_q)


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of the JAX package (``flash_attention.py:419-456``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, emit_lse):
        b, t, h, _ = q.shape
        block_q, block_k, t_pad = _pad_plan(t, block_q, block_k)
        out, lse = flash_fwd(_to_bhtd(q, t_pad), _to_bhtd(k, t_pad), _to_bhtd(v, t_pad),
                             t, causal, block_k, emit_lse)
        out = _from_bhtd(out, b, h, t)
        ctx.plan = (causal, block_q, block_k, t_pad)
        if emit_lse:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, block_q, block_k, t_pad = ctx.plan
        b, t, h, _ = q.shape
        # D = rowsum(dO * O): plain tensor ops, as the JAX package leaves it to XLA.
        dd = (g.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, t)
        if t_pad != t:
            dd = F.pad(dd, (0, t_pad - t))
        dq, dk, dv = flash_bwd(_to_bhtd(q, t_pad), _to_bhtd(k, t_pad), _to_bhtd(v, t_pad),
                               _to_bhtd(g.to(q.dtype), t_pad), lse, dd.contiguous(), t, causal,
                               block_q, block_k)
        return (_from_bhtd(dq, b, h, t), _from_bhtd(dk, b, h, t), _from_bhtd(dv, b, h, t),
                None, None, None, None)


def flash_attention(q, k, v, causal=False, block_q=None, block_k=None):
    """Exact multi-head attention, ``[B, T, H, D]`` -> ``[B, T, H, D]``.

    CUDA tensors run the hand-written kernels, CPU tensors the plain
    versions. ``block_q``/``block_k`` default to 64 and go through
    ``_pad_plan``. Differentiable: when a gradient is needed the forward
    saves the logsumexp rows and the backward runs the dQ and dK/dV passes,
    with no ``[T, T]`` matrix in either direction.
    """
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError('flash_attention takes q, k, v of one [B, T, H, D] shape, got {} {} {}'
                         .format(tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    block_q = DEFAULT_BLOCK if block_q is None else block_q
    block_k = DEFAULT_BLOCK if block_k is None else block_k
    emit_lse = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k, emit_lse)
