"""The port on the card, held against its own CPU path. Every test here
needs a CUDA device and skips without one (the Triton kernel has no CPU
mode). The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from petastorm_tpu_torch import (CompressedImageCodec, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, make_tensor_reader, write_dataset)
from petastorm_tpu_torch.models.resnet import ResNetTiny, init_flax_like
from petastorm_tpu_torch.ops import augment, image_ops

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


@pytest.mark.parametrize('shape', [(5, 30, 30, 3), (3, 10, 10, 3), (2, 224, 224, 3)])
def test_normalize_kernel_matches_plain(dev, shape):
    g = torch.Generator(device=dev).manual_seed(0)
    x_u8 = torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
    flip = image_ops.sample_flip(shape[0], g, dev)
    scale, shift = image_ops._scale_shift(image_ops.IMAGENET_MEAN, image_ops.IMAGENET_STD, dev)
    for x in (x_u8, x_u8.float() + 0.25):
        for dtype in (torch.float32, torch.bfloat16):
            for fl in (None, flip):
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
