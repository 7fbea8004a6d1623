"""The port on the card, held against its own CPU path. Every test here
needs a CUDA device and skips without one (the Triton and CUDA C++ kernels
have no CPU mode). The file imports no JAX, so it also runs where JAX is
absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import copy

import numpy as np
import pytest
import torch

from petastorm_tpu_torch import (CompressedImageCodec, DeviceDatasetCache, ScalarCodec,
                                 TorchLoader, Unischema, UnischemaField, make_tensor_reader,
                                 write_dataset)
from petastorm_tpu_torch.models import (SwitchMoE, TransformerLM, ViT, create_train_state,
                                        make_lm_scan_train_step, make_lm_train_step,
                                        make_scan_train_step, make_train_step, moe_aux_loss)
from petastorm_tpu_torch.models import transformer, vit
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
    with pytest.raises(TypeError, match='images'):
        image_ops.normalize_images(x.to(torch.int32))
    with pytest.raises(TypeError, match='writes'):
        image_ops.normalize_images(x, dtype=torch.float64)
    with pytest.raises(ValueError, match='contiguous'):
        image_ops.normalize_images(x.transpose(1, 2))
    with pytest.raises(ValueError, match='flip'):
        image_ops.normalize_images(x, flip=torch.zeros(3, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError, match='one per channel'):
        image_ops.normalize_images(x, mean=(0.5, 0.5), std=(0.5, 0.5))


def _within_half_ulp_bound(got, want):
    """One f16 ulp (2^-10 of the value), at least 1e-6 where the formula cancels."""
    return bool(((got - want).abs() <= (want.abs() * 2.0 ** -10).clamp(min=1e-6)).all())


@pytest.mark.parametrize('c', [1, 3, 4, 5, 8])
def test_normalize_kernel_takes_any_channels_and_the_jax_dtypes(dev, c):
    """C <= 4 takes the scalar path, C > 4 the per-channel table; every
    input type the JAX function takes, every output type, flipped and not,
    against the plain version."""
    g = torch.Generator(device=dev).manual_seed(c)
    shape = (3, 17, 33, c)
    x_u8 = torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
    flip = image_ops.sample_flip(shape[0], g, dev)
    mean = tuple(0.1 + 0.07 * i for i in range(c))
    std = tuple(0.2 + 0.05 * i for i in range(c))
    scale, shift = image_ops._scale_shift(mean, std, dev)
    for x in (x_u8, x_u8.half(), x_u8.bfloat16(), x_u8.float() + 0.25):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for fl in (None, flip):
                before = image_ops.LAUNCHES['normalize_images']
                got = image_ops.normalize_images(x, mean, std, dtype=dtype, flip=fl)
                assert image_ops.LAUNCHES['normalize_images'] == before + 1
                want = image_ops.normalize_images_plain(x, scale, shift, dtype, fl)
                assert got.dtype == dtype and got.shape == x.shape
                if dtype == torch.float32:
                    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
                elif dtype == torch.bfloat16:
                    assert _within_bf16_ulp(got.float(), want.float())
                else:
                    assert _within_half_ulp_bound(got.float(), want.float())


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


def _card_store(tmp_path, rows=60):
    schema = Unischema('CardSchema', [
        UnischemaField('image', np.uint8, (16, 16, 3), CompressedImageCodec('png')),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64)),
    ])
    rng = np.random.default_rng(3)
    url = 'file://' + str(tmp_path / 'store')
    write_dataset(url, schema, ({'image': rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
                                 'label': i} for i in range(rows)), rows_per_row_group=12)
    return url


def test_cuda_superbatches_and_device_cache_equal_the_cpu(dev, tmp_path):
    url = _card_store(tmp_path)

    def superbatches(device):
        with make_tensor_reader(url, workers_count=1, shuffle_row_groups=False,
                                cache_type='memory', num_epochs=2) as reader:
            with TorchLoader(reader, 8, device=device) as loader:
                return [(b.image.cpu(), b.label.cpu()) for b in loader.superbatches(3)]

    on_host, on_card = superbatches('cpu'), superbatches(dev)
    assert len(on_card) == len(on_host) == 120 // 8 // 3
    for (image, label), (want_image, want_label) in zip(on_card, on_host):
        assert torch.equal(image, want_image) and torch.equal(label, want_label)
    with make_tensor_reader(url, workers_count=1, num_epochs=1) as reader:
        with TorchLoader(reader, 8, device=dev) as loader:
            cache = DeviceDatasetCache(loader, shuffle=True, seed=1, superbatch_batches=3)
            first = [b.label.cpu() for b in cache.epoch(0)]
    for epoch in (1, 2):
        batches = list(cache.epoch(epoch))
        assert all(b.label.is_cuda and b.image.is_cuda for b in batches)
        labels = torch.cat([b.label.cpu() for b in batches])
        assert sorted(labels.tolist()) == sorted(torch.cat(first).tolist())


def _tiny_resnet(dev):
    model = init_flax_like(ResNetTiny(num_classes=10, dtype=torch.bfloat16, device=dev),
                           torch.Generator().manual_seed(0))
    return model.to(memory_format=torch.channels_last)


def _tiny_lm(dev):
    model = TransformerLM(256, 128, 2, 2, 128, attention='flash', dtype=torch.bfloat16, device=dev)
    return transformer.init_flax_like(model, torch.Generator().manual_seed(0))


def _preprocess(images):
    return image_ops.normalize_images(images, dtype=torch.bfloat16)


def _image_superbatch(dev, seed, k):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randint(0, 256, (k * 8, 32, 32, 3), generator=g, device=dev, dtype=torch.uint8),
            torch.randint(0, 10, (k * 8,), generator=g, device=dev))


def _token_superbatch(dev, seed, k):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randint(0, 256, (k * 2, 129), generator=g, device=dev, dtype=torch.int32),)


def _eager_resnet(k):
    """K calls of the one-step trainer on the microbatch slices, metrics
    stacked and averaged as the scan step does: its eager reference."""
    train_step = make_train_step()

    def run(state, images, labels):
        micro = images.shape[0] // k
        out = [train_step(state, _preprocess(images[i * micro:(i + 1) * micro]),
                          labels[i * micro:(i + 1) * micro]) for i in range(k)]
        losses = torch.stack([m['loss'] for m in out])
        return {'loss': losses.mean(), 'accuracy': torch.stack([m['accuracy'] for m in out]).mean(),
                'last_loss': losses[-1]}

    return run


def _eager_lm(k):
    train_step = make_lm_train_step()

    def run(state, tokens):
        micro = tokens.shape[0] // k
        return {'losses': torch.stack([train_step(state, tokens[i * micro:(i + 1) * micro])['loss']
                                       for i in range(k)])}

    return run


CASES = {
    'resnet': (_tiny_resnet, lambda k: make_scan_train_step(k, _preprocess), _eager_resnet,
               _image_superbatch),
    'lm': (_tiny_lm, make_lm_scan_train_step, _eager_lm, _token_superbatch),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_scan_graph_matches_eager_k_steps(dev, case):
    """Three calls of K = 4 steps from one state, through the graph (call 1
    warms up eagerly, call 2 captures and replays, call 3 replays) and as
    K calls of the one-step trainer. The LM's kernels and products are
    deterministic: exact equality. ResNet's cuDNN backward may sum with
    atomics: rtol 1e-2, atol 1e-3 on the metrics and every param and
    running statistic."""
    build, make_step, make_eager, superbatch = CASES[case]
    model = build(dev)
    states = [create_train_state(m, learning_rate=0.05, momentum=0.9)
              for m in (model, copy.deepcopy(model))]
    steps = [make_eager(4), make_step(4)]
    results = [[], []]
    for call in range(3):
        inputs = superbatch(dev, call, 4)
        for i in (0, 1):
            results[i].append(steps[i](states[i], *inputs))
    torch.cuda.synchronize()
    assert steps[1].graph is not None
    assert states[0].step == states[1].step == 12
    exact = case == 'lm'
    for eager, graphed in zip(*results):
        assert set(eager) == set(graphed)
        for name in eager:
            if exact:
                assert torch.equal(eager[name], graphed[name]), name
            else:
                torch.testing.assert_close(graphed[name], eager[name], rtol=1e-2, atol=1e-3)
    for (name, a), (_, b) in zip(states[0].model.state_dict().items(),
                                 states[1].model.state_dict().items()):
        if exact:
            assert torch.equal(a, b), name
        else:
            torch.testing.assert_close(b.float(), a.float(), rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize('case', sorted(CASES))
def test_scan_graph_replays_advance_and_keep_earlier_metrics(dev, case):
    build, make_step, _, superbatch = CASES[case]
    state = create_train_state(build(dev), learning_rate=0.05, momentum=0.9)
    step = make_step(2)
    inputs = superbatch(dev, 0, 2)
    step(state, *inputs)
    second = step(state, *inputs)
    kept = {name: value.clone() for name, value in second.items()}
    params = [p.detach().clone() for p in state.model.parameters()]
    third = step(state, *inputs)
    torch.cuda.synchronize()
    for name in kept:
        assert torch.equal(second[name], kept[name]), name        # not overwritten by call 3
    assert any(not torch.equal(a, b) for a, b in zip(params, state.model.parameters()))
    losses = [m['loss' if case == 'resnet' else 'losses'] for m in (second, third)]
    assert not torch.equal(losses[0], losses[1])                  # the same data, later params
    assert state.step == 6 and step.calls == 3
    with pytest.raises(ValueError, match='captured for'):
        step(state, *superbatch(dev, 0, 4))
    with pytest.raises(ValueError, match='another TrainState'):
        step(create_train_state(build(dev)), *inputs)


def test_replay_refuses_a_changed_optimizer(dev):
    """The graph holds the learning rate it captured and the addresses of
    the momentum buffers: a new rate, or buffers that
    ``load_state_dict`` replaced, raise before the replay."""
    state = create_train_state(_tiny_lm(dev), learning_rate=0.05, momentum=0.9)
    step = make_lm_scan_train_step(2)
    inputs = _token_superbatch(dev, 0, 2)
    step(state, *inputs)
    step(state, *inputs)
    state.optimizer.param_groups[0]['lr'] = 0.01
    with pytest.raises(ValueError, match='optimizer changed'):
        step(state, *inputs)
    state.optimizer.param_groups[0]['lr'] = 0.05
    step(state, *inputs)                                           # as captured: replays
    state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    with pytest.raises(ValueError, match='optimizer changed'):
        step(state, *inputs)
    assert state.step == 6 and step.calls == 3


def _launch_counts():
    return dict(image_ops.LAUNCHES, **fa.LAUNCHES)


def _kernels_ran(run, names):
    """How many kernels whose name holds each of ``names`` ran on the card
    during ``run()``, counted by name in a profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return {name: sum(e.count for e in events if name in e.key) for name in names}


def _capturing_call(step, state, inputs, names):
    """Call 2 (capture, then the first replay) under the profiler: the
    wrappers' counts across it (the kernels the graph holds; a replay
    calls no wrapper) and the kernels that ran on the card."""
    before = _launch_counts()
    ran = _kernels_ran(lambda: step(state, *inputs), names)
    captured = {name: count - before.get(name, 0) for name, count in _launch_counts().items()
                if count != before.get(name, 0)}
    return captured, ran


def test_scan_graph_holds_and_replays_the_kernels(dev):
    """A replay of the image graph runs K1 K times; of the LM graph, K2-K4
    each once a layer a microbatch (here 2 x K), on the Hopper route (bf16,
    head dim 64). The capture itself runs nothing: the capturing call's
    trace holds its one replay's kernels, as a later replay's does."""
    k = 4
    state = create_train_state(_tiny_resnet(dev))
    step = make_scan_train_step(k, _preprocess)
    inputs = _image_superbatch(dev, 0, k)
    step(state, *inputs)
    names = ['normalize_kernel']
    assert _capturing_call(step, state, inputs, names) == (
        {'normalize_images': k}, {'normalize_kernel': k})
    assert _kernels_ran(lambda: step(state, *inputs), names) == {'normalize_kernel': k}
    lm = _tiny_lm(dev)
    state = create_train_state(lm)
    step = make_lm_scan_train_step(k)
    inputs = _token_superbatch(dev, 0, k)
    step(state, *inputs)
    names = ['flash_fwd_sm90_kernel', 'flash_dq_sm90_kernel', 'flash_dkv_sm90_kernel']
    wrappers = ('flash_fwd', 'flash_fwd_sm90', 'flash_dq', 'flash_dq_sm90', 'flash_dkv',
                'flash_dkv_sm90')
    assert _capturing_call(step, state, inputs, names) == (
        dict.fromkeys(wrappers, 2 * k), dict.fromkeys(names, 2 * k))
    assert _kernels_ran(lambda: step(state, *inputs), names) == dict.fromkeys(names, 2 * k)


def test_graph_kernels_reads_the_captured_kernel_nodes(dev):
    """The captured graph's kernel nodes, read through the driver's graph
    API, hold K1 K times (image graph) and each Hopper flash kernel 2 x K
    times (LM graph, 2 layers), as many as the wrappers counted across the
    capture."""
    from petastorm_tpu_torch.bench import graph_kernels
    k = 4
    state = create_train_state(_tiny_resnet(dev))
    step = make_scan_train_step(k, _preprocess)
    inputs = _image_superbatch(dev, 0, k)
    step(state, *inputs)
    step(state, *inputs)
    nodes = graph_kernels(step.graph)
    assert sum(n for name, n in nodes.items() if 'normalize_kernel' in name) == k
    assert step.replays == 1
    state = create_train_state(_tiny_lm(dev))
    step = make_lm_scan_train_step(k)
    inputs = _token_superbatch(dev, 0, k)
    step(state, *inputs)
    step(state, *inputs)
    nodes = graph_kernels(step.graph)
    for kernel in ('flash_fwd_sm90_kernel', 'flash_dq_sm90_kernel', 'flash_dkv_sm90_kernel'):
        assert sum(n for name, n in nodes.items() if kernel in name) == 2 * k, (kernel, nodes)


def test_capture_failure_raises_and_does_not_fall_back(dev):
    """A body that reads a value on the host cannot be captured: the second
    call raises, the state does not advance, and no later call runs eagerly."""
    state = create_train_state(_tiny_resnet(dev))

    def host_sync(images):
        if float(images.float().mean()) < 0:            # a device -> host read
            raise AssertionError('unreachable')
        return _preprocess(images)

    step = make_scan_train_step(2, host_sync)
    inputs = _image_superbatch(dev, 0, 2)
    step(state, *inputs)                                 # eager: fine
    for _ in range(2):
        with pytest.raises(RuntimeError):
            step(state, *inputs)
        assert step.graph is None and state.step == 2 and step.calls == 1


def _draw_augment(boxes):
    """An augment for the scan body that keeps each call's crop offsets."""
    def run(images, generator):
        n, h, w, _ = images.shape
        params = augment.sample_imagenet_train_augment(n, h, w, generator, images.device)
        boxes.append(params['box'][0])
        return augment.apply_imagenet_train_augment(images, params, 24, 24, dtype=torch.float32)

    return run


def test_augment_graph_replays_draw_anew_and_follow_the_generator(dev):
    """The augment inside the captured graph: two replays draw different
    boxes (the graph registered the generator, so each replay advances
    it), and a generator re-seeded to one state replays the same draws."""
    k, boxes = 2, []
    g = torch.Generator(device=dev).manual_seed(1)
    state = create_train_state(_tiny_resnet(dev))
    step = make_scan_train_step(k, _draw_augment(boxes), generator=g)
    inputs = _image_superbatch(dev, 0, k)
    step(state, *inputs)                                 # eager
    step(state, *inputs)                                 # capture, replay 1
    assert step.graph is not None
    captured = boxes[-1]                                 # the graph rewrites it each replay
    first = captured.clone()
    step(state, *inputs)                                 # replay 2
    second = captured.clone()
    assert not torch.equal(first, second)
    replays = []
    for _ in range(2):
        g.manual_seed(5)
        step(state, *inputs)
        replays.append(captured.clone())
    assert torch.equal(replays[0], replays[1]) and not torch.equal(replays[0], second)
    assert len(boxes) == 2 * k                           # the body ran in call 1 and the capture


def test_augment_graph_refuses_an_unregistered_generator(dev):
    """A preprocess that draws from a generator the step was not given:
    the capture raises, and nothing replays or falls back to eager."""
    g = torch.Generator(device=dev).manual_seed(1)
    state = create_train_state(_tiny_resnet(dev))
    step = make_scan_train_step(2, lambda images: augment.imagenet_train_augment(
        images, g, 24, 24, dtype=torch.float32))
    inputs = _image_superbatch(dev, 0, 2)
    step(state, *inputs)
    with pytest.raises(RuntimeError):
        step(state, *inputs)
    assert step.graph is None and state.step == 2


def test_imagenet_eval_preprocess_on_card_matches_plain(dev):
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (3, 60, 44, 3), dtype=np.uint8))
    want = augment.imagenet_eval_preprocess(x, 32, 32, dtype=torch.float32)
    before = image_ops.LAUNCHES['normalize_images']
    got = augment.imagenet_eval_preprocess(x.to(dev), 32, 32, dtype=torch.float32)
    assert image_ops.LAUNCHES['normalize_images'] == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def test_vit_flash_on_card_matches_dense_on_card(dev):
    """ViT in bf16 at patch 16 on 224x224 images: T = 197, non-causal, head
    dim 64, through the Hopper route (forward, dQ, dK/dV a layer each),
    against the dense attention on the same weights; logits within 2^-4
    (two bf16 ulps at |x| < 8), the patch embedding's gradient within 2^-4
    of its largest entry."""
    results = []
    x = torch.rand((2, 224, 224, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    for attention in ('dense', 'flash'):
        model = vit.init_flax_like(ViT(10, d_model=128, num_heads=2, num_layers=2,
                                       attention=attention, dtype=torch.bfloat16, device=dev),
                                   torch.Generator().manual_seed(0))
        before = dict(fa.LAUNCHES)
        logits = model(x)
        logits.square().mean().backward()
        torch.cuda.synchronize()
        launched = {name: fa.LAUNCHES[name] - before.get(name, 0)
                    for name in ('flash_fwd_sm90', 'flash_dq_sm90', 'flash_dkv_sm90')}
        results.append((logits.detach().cpu(), model.patch_embed.weight.grad.float().cpu(),
                        launched))
    (dense, dense_grad, none), (flash, flash_grad, launched) = results
    assert none == dict.fromkeys(none, 0) and launched == dict.fromkeys(launched, 2)
    assert bool(torch.isfinite(flash).all()) and float(dense.abs().max()) < 8
    torch.testing.assert_close(flash, dense, rtol=0, atol=2 ** -4)
    assert float((flash_grad - dense_grad).abs().max()) <= 2 ** -4 * float(dense_grad.abs().max())


def test_switch_moe_on_card_matches_cpu(dev):
    """The layer (f32, TF32 off): out and aux loss against the CPU, and
    overflow tokens come out zero on the card too (capacity factor 0.5)."""
    x = torch.randn((4, 64, 32), generator=torch.Generator().manual_seed(2))
    for capacity_factor in (1.25, 0.5):
        layer = SwitchMoE(32, 4, capacity_factor=capacity_factor, dtype=torch.float32)
        transformer.init_flax_like(layer, torch.Generator().manual_seed(3))
        with torch.no_grad():
            want, want_aux = layer(x), layer.aux_loss
            got = layer.to(dev)(x.to(dev))
            got_aux = layer.aux_loss.cpu()
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(got_aux, want_aux, atol=1e-5, rtol=1e-5)
    assert int((want.abs().sum(-1) == 0).sum()) > 0 and torch.equal(
        got.cpu().abs().sum(-1) == 0, want.abs().sum(-1) == 0)


def test_moe_lm_on_card_matches_cpu(dev):
    def build(where):
        model = TransformerLM(512, 64, 4, 2, 96, attention='flash', moe_experts=4,
                              dtype=torch.float32, device=where)
        return transformer.init_flax_like(model, torch.Generator().manual_seed(0))

    tokens = torch.randint(0, 512, (2, 90), generator=torch.Generator().manual_seed(1))
    results = []
    for where in ('cpu', dev):
        model = build(where)
        logits = model(tokens.to(where))
        aux = moe_aux_loss(model)
        (logits.square().mean() + 1e-2 * aux).backward()
        results.append((logits.detach().cpu(), aux.detach().cpu(),
                        model.blocks[0].moe.router.weight.grad.cpu(),
                        model.blocks[1].moe.w_up.grad.cpu()))
    for got, want in zip(results[1], results[0]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _surface_store(tmp_path, rows=120):
    schema = Unischema('SurfaceCardSchema', [
        UnischemaField('id', np.int32, (), ScalarCodec(np.int32)),
        UnischemaField('image', np.uint8, (48, 48, 3), CompressedImageCodec('png')),
        UnischemaField('ragged', np.uint8, (None, None, 3), CompressedImageCodec('png')),
    ])
    rng = np.random.default_rng(4)
    url = 'file://' + str(tmp_path / 'surface')
    write_dataset(url, schema, ({
        'id': i, 'image': rng.integers(0, 256, (48, 48, 3), dtype=np.uint8),
        'ragged': rng.integers(0, 256, (int(rng.integers(20, 30)), int(rng.integers(20, 30)), 3),
                               dtype=np.uint8)} for i in range(rows)), rows_per_row_group=16)
    return url


def _surface_batches(url, kind, device, **options):
    from petastorm_tpu_torch import CropTo, make_reader
    if kind == 'row':
        reader = make_reader(url, schema_fields=['id', 'ragged'], workers_count=1,
                             shuffle_row_groups=False)
        options['shape_policies'] = {'ragged': CropTo((20, 20, 3))}
    else:
        reader = make_tensor_reader(url, schema_fields=['id', 'image'], workers_count=1,
                                    shuffle_row_groups=False)
    with reader:
        with TorchLoader(reader, 16, device=device, **options) as loader:
            out = []
            for batch in loader:
                assert all(t.device.type == torch.device(device).type for t in batch)
                out.append([t.cpu() for t in batch])
            return out, loader.stats


@pytest.mark.parametrize('kind', ['tensor', 'row'])
def test_loader_options_equal_the_default_on_card(dev, tmp_path, kind):
    """prefetch=0, the inflight window and a shallow arena pool give the
    default's batches bit for bit on the card (and the CPU's); echo=2
    delivers each twice and counts its rows once."""
    url = _surface_store(tmp_path)
    want, _ = _surface_batches(url, kind, 'cpu')
    assert len(want) == 120 // 16
    for options in ({}, dict(prefetch=0), dict(prefetch=2, inflight=1),
                    dict(prefetch=2, inflight=4, arena_depth=3), dict(echo=2)):
        got, stats = _surface_batches(url, kind, 'cuda', **options)
        expect = [b for b in want for _ in range(options.get('echo', 1))]
        assert len(got) == len(expect) == stats['batches'], options
        assert stats['rows'] == len(want) * 16
        for a, b in zip(got, expect):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), options


@pytest.mark.parametrize('inflight', [1, 3])
def test_prefetch_zero_recycles_pinned_arenas_only_after_their_copy(dev, tmp_path, inflight):
    """prefetch=0 collates into pinned arenas on the consumer's thread. Each
    copy is held back behind a spin of the loader's copy stream and the
    consumer is slow too (a spin on its own stream and a host sleep): if an
    arena went back to the pool before its copy landed, the next collate
    would overwrite rows still to be copied."""
    import time
    url = _surface_store(tmp_path, rows=160)
    want, _ = _surface_batches(url, 'tensor', 'cpu')
    with make_tensor_reader(url, schema_fields=['id', 'image'], workers_count=1,
                            shuffle_row_groups=False) as reader:
        with TorchLoader(reader, 16, device='cuda', prefetch=0, inflight=inflight,
                         arena_depth=inflight + 1) as loader:
            got = []
            for _ in range(len(want)):
                with torch.cuda.stream(loader._h2d_stream):
                    torch.cuda._sleep(20_000_000)       # the next copy waits ~10 ms
                batch = next(loader)
                torch.cuda._sleep(5_000_000)            # the consumer's step
                time.sleep(0.002)
                got.append(batch)
            with pytest.raises(StopIteration):
                next(loader)
            stats = loader.stats
            torch.cuda.synchronize()
            got = [[t.cpu() for t in b] for b in got]
    assert all(all(torch.equal(x, y) for x, y in zip(a, b)) for a, b in zip(got, want))
    assert stats['arena_pinned'] and stats['arena_reuse'] > 0
    assert stats['arena_alloc'] <= inflight + 1 and stats['h2d_bytes'] > 0


# -- resume and the job checkpointer on the card (PR 8) -------------------------------

def test_job_checkpoint_round_trips_cuda_state(dev, tmp_path):
    """A ResNetTiny state on the card after two SGD steps: DCP saves and
    restores its params, BatchNorm buffers, momentum buffers and step bit
    for bit, into a fresh state on the card, sync and async."""
    from petastorm_tpu_torch.job_checkpoint import JobCheckpointer
    state = create_train_state(_tiny_resnet(dev), learning_rate=0.1, momentum=0.9)
    step = make_train_step()
    for seed in (0, 1):
        images, labels = _image_superbatch(dev, seed, 1)
        step(state, _preprocess(images), labels)
    for async_save in (False, True):
        root = tmp_path / ('async' if async_save else 'sync')
        with JobCheckpointer(str(root), async_save=async_save) as ckpt:
            assert ckpt.save(2, state, extra={'epoch': 0})
            ckpt.wait()
        fresh = create_train_state(_tiny_resnet(dev), learning_rate=0.1, momentum=0.9)
        with JobCheckpointer(str(root)) as ckpt:
            job = ckpt.restore(fresh)
        assert job.step == 2 and job.extra == {'epoch': 0} and fresh.step == 2
        for (name, a), b in zip(state.model.state_dict().items(),
                                fresh.model.state_dict().values()):
            assert b.is_cuda and torch.equal(a, b), name
        for p, q in zip(state.model.parameters(), fresh.model.parameters()):
            assert torch.equal(state.optimizer.state[p]['momentum_buffer'],
                               fresh.optimizer.state[q]['momentum_buffer'])


def test_scan_step_across_a_restore(dev, tmp_path):
    """``restore`` loads in place: restored into the state a ScanStep was
    captured on, every tensor keeps its address and the graph replays from
    the restored values, equal to eager steps from the checkpoint restored
    into a fresh state. A resumed job restores into a new TrainState: the
    old step raises there, and a new one captures and matches eager steps."""
    from petastorm_tpu_torch.job_checkpoint import JobCheckpointer

    def restored():
        fresh = create_train_state(_tiny_resnet(dev), learning_rate=0.05, momentum=0.9)
        with JobCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            ckpt.restore(fresh)
        return fresh

    state = create_train_state(_tiny_resnet(dev), learning_rate=0.05, momentum=0.9)
    old = make_scan_train_step(2, _preprocess)
    old(state, *_image_superbatch(dev, 0, 2))
    old(state, *_image_superbatch(dev, 1, 2))           # captured and replayed
    with JobCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
        ckpt.save(state.step, state)
        old(state, *_image_superbatch(dev, 2, 2))       # the state moves past the save
        ckpt.restore(state)
    eager = _eager_resnet(2)
    reference = restored()
    for seed in (3, 4):
        inputs = _image_superbatch(dev, seed, 2)
        torch.testing.assert_close(old(state, *inputs)['loss'],
                                   eager(reference, *inputs)['loss'], rtol=1e-2, atol=1e-3)
    resumed, reference = restored(), restored()
    with pytest.raises(ValueError, match='another TrainState'):
        old(resumed, *_image_superbatch(dev, 5, 2))
    new = make_scan_train_step(2, _preprocess)
    for seed in (6, 7, 8):
        inputs = _image_superbatch(dev, seed, 2)
        torch.testing.assert_close(new(resumed, *inputs)['loss'],
                                   eager(reference, *inputs)['loss'], rtol=1e-2, atol=1e-3)
    assert new.graph is not None


def test_pinned_prefetching_loader_resume_loses_and_repeats_no_row(dev, tmp_path):
    """A tensor reader through a pinned-arena loader with prefetch 2 on the
    card, checkpointed after 3 batches while more sit staged: the resumed
    loader delivers exactly the rows the first did not, once each, for the
    default and the deterministic mode."""
    url = _surface_store(tmp_path, rows=160)
    for deterministic in (False, True):
        kwargs = dict(schema_fields=['id', 'image'], workers_count=3, seed=1,
                      deterministic=deterministic)
        seen = []
        with make_tensor_reader(url, **kwargs) as reader:
            with TorchLoader(reader, 16, device='cuda', prefetch=2) as loader:
                for _ in range(3):
                    seen += next(loader).id.cpu().tolist()
                state = loader.state_dict()
        with make_tensor_reader(url, resume_state=state, **kwargs) as reader:
            with TorchLoader(reader, 16, device='cuda', prefetch=2) as loader:
                for batch in loader:
                    seen += batch.id.cpu().tolist()
        assert sorted(seen) == list(range(160)), deterministic


# -- the cache hierarchy on the card ---------------------------------------------------

@pytest.fixture
def governor(monkeypatch):
    """A fresh process-wide memory governor (1 MB budget), armed without its
    sampler: the test drives ``check()``."""
    from petastorm_tpu_torch import membudget
    monkeypatch.delenv(membudget.ENV_VAR, raising=False)
    gov = membudget.MemoryGovernor(budget=1_000_000)
    previous = membudget.set_governor(gov)
    gov._arm_count += 1
    try:
        yield gov
    finally:
        while gov._arm_count > 0:
            gov.release()
        membudget.set_governor(previous)


def test_chunk_store_batches_through_pinned_arenas_equal_the_cpu_path(dev, tmp_path):
    """A store filled by a CPU pass serves the card's loader (every
    row-group a hit, nothing decoded); its batches, copied from the mapped
    entries into pinned arenas, equal the CPU path's decoded ones."""
    url = _surface_store(tmp_path)
    want, _ = _surface_batches(url, 'tensor', 'cpu')
    store_dir = str(tmp_path / 'store')
    with make_tensor_reader(url, schema_fields=['id', 'image'], workers_count=1,
                            shuffle_row_groups=False, cache_type='chunk-store',
                            cache_location=store_dir) as reader:
        assert sum(len(c.id) for c in reader) == 120
    for _ in range(2):
        # Two workers, resequenced: chunks arrive in the CPU pass's order.
        with make_tensor_reader(url, schema_fields=['id', 'image'], workers_count=2,
                                shuffle_row_groups=False, deterministic=True,
                                cache_type='chunk-store', cache_location=store_dir) as reader:
            with TorchLoader(reader, 16, device='cuda') as loader:
                got = [[t.cpu() for t in b] for b in loader]
                stats = loader.stats
        assert stats['arena_pinned'] and stats['chunk_store']['misses'] == 0
        assert stats['worker_stage_timings']['decode_s'] == 0.0
        assert len(got) == len(want)
        assert all(all(torch.equal(x, y) for x, y in zip(a, b)) for a, b in zip(got, want))


def test_partial_cache_on_card_evicts_under_a_ballast_pool(dev, tmp_path, governor):
    """The partial cache on the card: a ballast pool drives one check to
    degrade, which evicts the coldest run; the card's allocated bytes fall
    by the run's, and the next epoch is still the whole streamed pass."""
    url = _surface_store(tmp_path)

    def factory():
        with make_tensor_reader(url, schema_fields=['id', 'image'], workers_count=1,
                                shuffle_row_groups=False) as reader:
            with TorchLoader(reader, 16, device='cuda') as loader:
                yield from loader

    want = [[t.cpu() for t in b] for b in factory()]
    batch_bytes = 16 * (4 + 48 * 48 * 3)     # int32 id, 48x48x3 uint8 image
    reader = make_tensor_reader(url, schema_fields=['id', 'image'], workers_count=1,
                                shuffle_row_groups=False)
    loader = TorchLoader(reader, 16, device='cuda')
    cache = DeviceDatasetCache(loader, shuffle=False, partial=True, superbatch_batches=2,
                               max_bytes=4 * batch_bytes + 1, loader_factory=factory)
    with reader, loader:
        assert len(list(cache.epoch(0))) == len(want)
    assert cache.stats()['cached_batches'] == 4 and cache.stats()['fill_stopped']
    got = [[t.cpu() for t in b] for b in cache.epoch(1)]
    assert all(all(torch.equal(x, y) for x, y in zip(a, b)) for a, b in zip(got, want))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    ballast = governor.register_pool('ballast', lambda: 860_000 - cache.nbytes)
    assert governor.check() == 'degrade'
    assert cache.stats()['evictions'] == 1 and cache.stats()['cached_batches'] == 2
    freed = before - torch.cuda.memory_allocated(dev)
    assert 2 * batch_bytes <= freed < 2 * batch_bytes + 4096
    ballast.close()
    got = [[t.cpu() for t in b] for b in cache.epoch(2)]
    assert all(all(torch.equal(x, y) for x, y in zip(a, b)) for a, b in zip(got, want))
    cache.clear()


def test_arena_advisory_toggle_mid_stream_keeps_batches(dev, tmp_path, governor):
    """The advisory rung unpins the loader's new arenas: a copy from them
    is synchronous to the host, and the batches (arenas allocated unpinned
    first, then pinned again after the relief) still equal the CPU's."""
    url = _surface_store(tmp_path)
    want, _ = _surface_batches(url, 'tensor', 'cpu')
    ballast = governor.register_pool('ballast', lambda: 750_000)
    assert governor.check() == 'advisory'
    with make_tensor_reader(url, schema_fields=['id', 'image'], workers_count=1,
                            shuffle_row_groups=False) as reader:
        with TorchLoader(reader, 16, device='cuda', arena_depth=2) as loader:
            assert not loader.stats['arena_pinned']    # joined the episode at registration
            got = [[t.cpu() for t in next(loader)] for _ in range(3)]
            ballast.close()
            assert governor.check() == 'ok'
            assert loader.stats['arena_pinned']
            got += [[t.cpu() for t in b] for b in loader]
    assert len(got) == len(want)
    assert all(all(torch.equal(x, y) for x, y in zip(a, b)) for a, b in zip(got, want))


# -- the mesh paths at world size 1, over NCCL ----------------------------------

@pytest.fixture
def nccl_world_of_one(dev, tmp_path):
    """An NCCL process group of one rank, started from a file and destroyed
    after the test (the card machine has one GPU)."""
    import torch.distributed as dist
    device = torch.device('cuda', torch.cuda.current_device())
    dist.init_process_group('nccl', init_method='file://' + str(tmp_path / 'init'), rank=0,
                            world_size=1, device_id=device)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def test_mesh_scan_step_on_nccl_matches_the_single_gpu_step(nccl_world_of_one):
    """ResNetTiny on ``{'data': 1, 'model': 1}``: three calls of K = 4
    steps through the captured graph, with the gradient all-reduce and the
    split head, against the same state without a mesh (rtol 1e-2, atol
    1e-3: cuDNN's backward may sum with atomics)."""
    from petastorm_tpu_torch.parallel import make_mesh
    dev = nccl_world_of_one
    mesh = make_mesh({'data': 1, 'model': 1})
    model = _tiny_resnet(dev)
    plain = create_train_state(copy.deepcopy(model), learning_rate=0.05, momentum=0.9)
    meshed = create_train_state(model, learning_rate=0.05, momentum=0.9, mesh=mesh)
    assert sorted(meshed.placements) == ['head.bias', 'head.weight']
    steps = [make_scan_train_step(4, _preprocess), make_scan_train_step(4, _preprocess, mesh=mesh)]
    for call in range(3):
        inputs = _image_superbatch(dev, call, 4)
        want, got = (step(state, *inputs) for step, state in zip(steps, (plain, meshed)))
        for name in want:
            torch.testing.assert_close(got[name], want[name], rtol=1e-2, atol=1e-3)
    assert steps[1].graph is not None
    for a, b in zip(plain.model.state_dict().values(), meshed.model.state_dict().values()):
        torch.testing.assert_close(b.float(), a.float(), rtol=1e-2, atol=1e-3)


def test_mesh_scan_graph_holds_the_gradient_all_reduce(nccl_world_of_one):
    """NCCL's one-rank reduction kernel (``ReduceOp.AVG``) is a node of the
    captured graph K times, beside K1's K: the all-reduce is inside the
    graph, and each replay runs it K times."""
    from petastorm_tpu_torch.bench import graph_launches
    from petastorm_tpu_torch.parallel import make_mesh
    dev = nccl_world_of_one
    mesh = make_mesh({'data': 1, 'model': 1})
    state = create_train_state(_tiny_resnet(dev), learning_rate=0.05, momentum=0.9, mesh=mesh)
    step = make_scan_train_step(4, _preprocess, mesh=mesh)
    for call in range(2):
        step(state, *_image_superbatch(dev, call, 4))
    inputs = _image_superbatch(dev, 2, 4)
    for _ in range(10):
        step(state, *inputs)
    assert step.replays == 11
    assert graph_launches(step, ('oneRankReduce', 'normalize_kernel'), step.replays) == {
        'oneRankReduce': 44, 'normalize_kernel': 44}
