"""The port on the card, held against its own CPU path. Every test here
needs a CUDA device and skips without one (the Triton and CUDA C++ kernels
have no CPU mode). The file imports no JAX, so it also runs where JAX is
absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from petastorm_tpu_torch import (CompressedImageCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, make_tensor_reader, write_dataset)
from petastorm_tpu_torch.models import TransformerLM
from petastorm_tpu_torch.models import transformer
from petastorm_tpu_torch.models.resnet import ResNetTiny, init_flax_like
from petastorm_tpu_torch.ops import augment, image_ops
from petastorm_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the port\'s kernels run only on the card')
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # f32 parity
    yield torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _within_bf16_ulp(got, want):
    _, exponent = torch.frexp(want.abs().clamp(min=2.0 ** -126))
    return bool(((got - want).abs() <= torch.ldexp(torch.ones_like(want), exponent - 8)
                 .clamp(min=1e-6)).all())


@pytest.mark.parametrize('shape', [(5, 30, 30, 3), (3, 10, 10, 3), (2, 224, 224, 3),
                                   (1, 7, 513, 3), (3, 224, 224, 3)])
def test_normalize_kernel_matches_plain(dev, shape):
    """Every variant, with rows that do not fill a block and samples that
    span many; each sample is checked flipped and not."""
    g = torch.Generator(device=dev).manual_seed(0)
    x_u8 = torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
    flip = image_ops.sample_flip(shape[0], g, dev)
    scale, shift = image_ops._scale_shift(image_ops.IMAGENET_MEAN, image_ops.IMAGENET_STD, dev)
    for x in (x_u8, x_u8.float() + 0.25):
        for dtype in (torch.float32, torch.bfloat16):
            for fl in (None, flip, ~flip):
                before = image_ops.LAUNCHES['normalize_images']
                got = image_ops.normalize_images(x, dtype=dtype, flip=fl)
                assert image_ops.LAUNCHES['normalize_images'] == before + 1
                want = image_ops.normalize_images_plain(x, scale, shift, dtype, fl)
                assert got.dtype == dtype and got.shape == x.shape
                if dtype == torch.float32:
                    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
                else:
                    assert _within_bf16_ulp(got.float(), want.float())


def test_normalize_kernel_rejects_what_it_cannot_take(dev):
    x = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError):
        image_ops.normalize_images(x.to(torch.int32))
    with pytest.raises(ValueError, match='contiguous'):
        image_ops.normalize_images(x.transpose(1, 2))
    with pytest.raises(ValueError, match='flip'):
        image_ops.normalize_images(x, flip=torch.zeros(3, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError, match='channels'):
        image_ops.normalize_images(torch.zeros((2, 8, 8, 5), dtype=torch.uint8, device=dev),
                                   mean=(0.5,) * 5, std=(0.5,) * 5)
    with pytest.raises(ValueError, match='one per channel'):
        image_ops.normalize_images(x, mean=(0.5, 0.5), std=(0.5, 0.5))


def test_imagenet_augment_on_card_matches_cpu(dev):
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (4, 48, 40, 3), dtype=np.uint8))
    params = augment.sample_imagenet_train_augment(4, 48, 40, torch.Generator().manual_seed(2), 'cpu')
    want = augment.apply_imagenet_train_augment(x, params, 32, 32, dtype=torch.float32)
    on_card = {'box': tuple(v.to(dev) for v in params['box']), 'flip': params['flip'].to(dev),
               'jitter': tuple(v.to(dev) for v in params['jitter'])}
    got = augment.apply_imagenet_train_augment(x.to(dev), on_card, 32, 32, dtype=torch.float32)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def test_resnet_tiny_on_card_matches_cpu(dev):
    model = init_flax_like(ResNetTiny(num_classes=10, dtype=torch.float32, device='cpu'),
                           torch.Generator().manual_seed(0))
    x = torch.randn((4, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)
        got = model.to(dev)(x.to(dev)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_cuda_loader_batches_equal_cpu_loader(dev, tmp_path):
    schema = Unischema('CardSchema', [
        UnischemaField('image', np.uint8, (16, 16, 3), CompressedImageCodec('png')),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64)),
    ])
    rng = np.random.default_rng(3)
    url = 'file://' + str(tmp_path / 'store')
    write_dataset(url, schema, ({'image': rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
                                 'label': i} for i in range(60)), rows_per_row_group=12)

    def batches(device, prefetch):
        with make_tensor_reader(url, workers_count=1, shuffle_row_groups=False) as reader:
            with TorchLoader(reader, 8, device=device, prefetch=prefetch) as loader:
                out = [(b.image.cpu(), b.label.cpu(), b.image.device.type) for b in loader]
                assert loader.stats['rows'] == 56
                return out

    on_host = batches('cpu', 2)
    for prefetch in (1, 2):
        on_card = batches('cuda', prefetch)
        assert len(on_card) == len(on_host) == 7
        for (image, label, where), (want_image, want_label, _) in zip(on_card, on_host):
            assert where == 'cuda'
            assert torch.equal(image, want_image) and torch.equal(label, want_label)


def _flash_close(got, want, dtype):
    """f32: atol=rtol=1e-5. bf16: two bf16 ulps plus 2^-8 of the largest
    value (P and dS round to bf16 at the same places on both sides; an ulp
    flips where an f32 sum lands on the other side of a boundary)."""
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        bound = 1e-5 + 1e-5 * want.abs()
    else:
        _, exponent = torch.frexp(want.abs().clamp(min=2.0 ** -126))
        bound = 2 * torch.ldexp(torch.ones_like(want), exponent - 8) + 2.0 ** -8 * want.abs().max()
    return bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('bh,t,d', [(6, 100, 16), (3, 77, 64), (2, 130, 128), (1, 7, 4)])
def test_flash_kernels_match_plain(dev, dtype, causal, bh, t, d):
    bq, bk, t_pad = fa._pad_plan(t, fa.DEFAULT_BLOCK, fa.DEFAULT_BLOCK)
    g = torch.Generator(device=dev).manual_seed(t)
    q, k, v, do = (torch.randn((bh, t_pad, d), generator=g, device=dev).to(dtype)
                   for _ in range(4))
    do[:, t:] = 0
    before = dict(fa.LAUNCHES)
    out, lse = fa.flash_fwd_cuda(q, k, v, t, causal, True)
    pout, plse = fa.flash_fwd_plain(q, k, v, t, causal, bk)
    dd = (do.float() * pout.float()).sum(-1)
    dq = fa.flash_dq_cuda(q, k, v, do, plse, dd, t, causal)
    dk, dv = fa.flash_dkv_cuda(q, k, v, do, plse, dd, t, causal)
    want = ((pout, plse, fa.flash_dq_plain(q, k, v, do, plse, dd, t, causal, bk))
            + fa.flash_dkv_plain(q, k, v, do, plse, dd, t, causal, bq))
    for name, a, b in zip(('out', 'lse', 'dq', 'dk', 'dv'), (out, lse, dq, dk, dv), want):
        assert a.dtype == b.dtype, name
        assert _flash_close(a[:, :t], b[:, :t], torch.float32 if name == 'lse' else dtype), name
    for name in ('flash_fwd', 'flash_dq', 'flash_dkv'):
        assert fa.LAUNCHES[name] == before.get(name, 0) + 1
    sm90 = int(fa.kernel_route(dtype, d) == 'cuda-sm90')
    for name in ('flash_fwd_sm90', 'flash_dq_sm90', 'flash_dkv_sm90'):
        assert fa.LAUNCHES[name] == before.get(name, 0) + sm90


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('d', [64, 128])
@pytest.mark.parametrize('t,seq_len', [(1000, 1000), (1024, 1024), (2048, 2048), (1024, 777)])
def test_sm90_flash_kernels_match_plain(dev, d, causal, t, seq_len):
    """The Hopper forward, dQ and dK/dV (bf16, D 64 or 128) against the
    plain versions on every row, T_pad included; seq_len < T_pad masks keys."""
    bq, bk, t_pad = fa._pad_plan(t, fa.DEFAULT_BLOCK, fa.DEFAULT_BLOCK)
    assert fa.kernel_route(torch.bfloat16, d) == 'cuda-sm90'
    g = torch.Generator(device=dev).manual_seed(seq_len + d)
    q, k, v, do = (torch.randn((3, t_pad, d), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    do[:, seq_len:] = 0                  # rows past seq_len carry no gradient
    before = dict(fa.LAUNCHES)
    out, lse = fa.flash_fwd_cuda(q, k, v, seq_len, causal, True)
    pout, plse = fa.flash_fwd_plain(q, k, v, seq_len, causal, bk)
    dd = (do.float() * pout.float()).sum(-1)
    dq = fa.flash_dq_cuda(q, k, v, do, plse, dd, seq_len, causal)
    pdq = fa.flash_dq_plain(q, k, v, do, plse, dd, seq_len, causal, bk)
    dk, dv = fa.flash_dkv_cuda(q, k, v, do, plse, dd, seq_len, causal)
    pdk, pdv = fa.flash_dkv_plain(q, k, v, do, plse, dd, seq_len, causal, bq)
    torch.cuda.synchronize()
    for name, a, b in (('out', out, pout), ('lse', lse, plse), ('dq', dq, pdq), ('dk', dk, pdk),
                       ('dv', dv, pdv)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _flash_close(a, b, torch.float32 if name == 'lse' else torch.bfloat16), name
    for name in ('flash_fwd', 'flash_fwd_sm90', 'flash_dq', 'flash_dq_sm90', 'flash_dkv',
                 'flash_dkv_sm90'):
        assert fa.LAUNCHES[name] == before.get(name, 0) + 1, name


def test_sm90_flash_forward_without_lse(dev):
    q, k, v = (torch.randn((2, 256, 64), device=dev).to(torch.bfloat16) for _ in range(3))
    out, lse = fa.flash_fwd_cuda(q, k, v, 200, True, False)
    want, _ = fa.flash_fwd_plain(q, k, v, 200, True, fa.DEFAULT_BLOCK)
    assert lse is None and _flash_close(out, want, torch.bfloat16)


def test_sm90_kernels_fit_shared_memory(dev):
    lib = fa._library(fa._SM90_SOURCE)
    for kernel in (0, 1, 2):             # flash_fwd_sm90, flash_dkv_sm90, flash_dq_sm90
        for d in fa.SM90_HEAD_DIMS:
            assert 0 < lib.flash_sm90_smem_bytes(kernel, d) <= 232448
        assert lib.flash_sm90_smem_bytes(kernel, 96) < 0
    assert lib.flash_sm90_smem_bytes(3, 64) < 0


def test_flash_wrappers_refuse_what_the_kernels_cannot_take(dev):
    x = torch.zeros((2, 16, 8), device=dev)
    lse = torch.zeros((2, 16), device=dev)
    with pytest.raises(ValueError, match='one CUDA device'):
        fa.flash_fwd_cuda(x, x.cpu(), x, 16, True, True)
    with pytest.raises(TypeError, match='bfloat16 or float32'):
        fa.flash_fwd_cuda(*(x.half(),) * 3, 16, True, True)
    with pytest.raises(TypeError, match='mixed types'):
        fa.flash_fwd_cuda(x, x.bfloat16(), x, 16, True, True)
    with pytest.raises(ValueError, match='contiguous'):
        y = torch.zeros((2, 8, 16), device=dev).transpose(1, 2)
        fa.flash_dq_cuda(y, y, y, y, lse, lse, 16, True)
    with pytest.raises(ValueError, match='head dim'):
        big = torch.zeros((2, 16, 129), device=dev)
        fa.flash_dkv_cuda(big, big, big, big, lse, lse, 16, True)
    with pytest.raises(ValueError, match='lse and D'):
        fa.flash_dkv_cuda(x, x, x, x, lse.bfloat16(), lse, 16, True)
    # The sm90 route (bf16, D 64 or 128) reads through TMA tensor maps.
    raw = torch.zeros(2 * 16 * 64 + 8, dtype=torch.bfloat16, device=dev)
    shifted = raw[1:1 + 2 * 16 * 64].view(2, 16, 64)
    with pytest.raises(ValueError, match='16-byte aligned'):
        fa.flash_fwd_cuda(shifted, shifted, shifted, 16, True, True)
    ragged = torch.zeros((2, 12, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match='multiple of 8'):
        fa.flash_dkv_cuda(ragged, ragged, ragged, ragged, lse[:, :12].contiguous(),
                          lse[:, :12].contiguous(), 12, True)


@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_autograd_on_card_matches_cpu(dev, causal):
    rng = np.random.default_rng(5)
    arrays = [torch.from_numpy(rng.standard_normal((2, 90, 3, 32)).astype(np.float32))
              for _ in range(4)]
    results = []
    for where in ('cpu', dev):
        q, k, v = (a.to(where, copy=True).requires_grad_() for a in arrays[:3])
        out = fa.flash_attention(q, k, v, causal=causal)
        (out * arrays[3].to(where)).sum().backward()
        results.append([x.detach().cpu() for x in (out, q.grad, k.grad, v.grad)])
    for got, want in zip(*results[::-1]):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_lm_on_card_matches_cpu(dev):
    def build(where):
        model = TransformerLM(512, 64, 4, 2, 96, attention='flash', dtype=torch.float32,
                              device=where)
        return transformer.init_flax_like(model, torch.Generator().manual_seed(0))

    tokens = torch.randint(0, 512, (2, 90), generator=torch.Generator().manual_seed(1))
    results = []
    for where in ('cpu', dev):
        model = build(where)
        logits = model(tokens.to(where))
        logits.square().mean().backward()
        results.append((logits.detach().cpu(), model.embed.weight.grad.cpu(),
                        model.blocks[0].attn.query.weight.grad.cpu()))
    for got, want in zip(results[1], results[0]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
