"""ResNet-50 on an ImageNet-style store of images of any size, through the
port: the per-row reader, ``CropTo`` collating rows straight into the
loader's pinned arenas, and either the bare ``/255`` cast or, with
``augment=True``, the on-device Inception recipe (random resized crop,
color jitter, flip) ending in the hand-written normalize kernel.
Counterpart of ``examples/imagenet/jax_resnet_example.py`` and
``generate_imagenet_dataset.py``. With ``model_parallel`` it trains on a
``{'data': world / model_parallel, 'model': model_parallel}`` mesh, one
process a GPU: each rank reads its data shard (``make_pod_reader``,
deterministic, so that the head's peers see one order), the batch is
global, the classifier head is split over ``'model'`` and the gradients
are averaged over ``'data'``.

    python -m petastorm_tpu_torch.examples.imagenet --generate --augment
    torchrun --nproc-per-node=8 -m petastorm_tpu_torch.examples.imagenet --model-parallel 2
"""

import argparse
import time

import numpy as np
import torch

from petastorm_tpu_torch import (CompressedImageCodec, CropTo, ScalarCodec, TorchLoader, Unischema,
                                 UnischemaField, make_pod_reader, make_reader, resolve_device,
                                 write_dataset)
from petastorm_tpu_torch.models import ResNet50, create_train_state, make_train_step
from petastorm_tpu_torch.models.resnet import init_flax_like
from petastorm_tpu_torch.ops.augment import imagenet_train_augment

ImagenetSchema = Unischema('ImagenetSchema', [
    UnischemaField('noun_id', np.str_, (), ScalarCodec(np.str_), False),
    UnischemaField('text', np.str_, (), ScalarCodec(np.str_), False),
    UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False),
    UnischemaField('image', np.uint8, (None, None, 3), CompressedImageCodec('jpeg', 90), False),
])


def _photo(rng, h, w):
    """A photo-like image (a low-frequency field plus mild noise), so JPEG
    sizes and decode costs are those of a photo, not of noise."""
    low = rng.integers(0, 255, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
    img = np.kron(low, np.ones((16, 16, 1), dtype=np.uint8))[:h, :w]
    noise = rng.integers(0, 24, (h, w, 3), dtype=np.uint8)
    return np.clip(img.astype(np.int16) + noise - 12, 0, 255).astype(np.uint8)


def generate_synthetic(output_url, classes=10, images_per_class=50, height=256, width=256,
                       ragged=0, rows_per_row_group=32, seed=0):
    """Write ``classes * images_per_class`` rows; with ``ragged > 0`` each
    image is up to ``ragged`` pixels taller and wider than ``height`` x
    ``width``."""
    rng = np.random.default_rng(seed)

    def rows():
        for label in range(classes):
            for _ in range(images_per_class):
                h, w = (height, width) if not ragged else (
                    height + int(rng.integers(0, ragged + 1)),
                    width + int(rng.integers(0, ragged + 1)))
                yield {'noun_id': 'n{:08d}'.format(label),
                       'text': 'synthetic_class_{}'.format(label),
                       'label': label, 'image': _photo(rng, h, w)}

    write_dataset(output_url, ImagenetSchema, rows(), rows_per_row_group=rows_per_row_group)
    print('Wrote {} rows to {}'.format(classes * images_per_class, output_url))


def train(dataset_url, batch_size=256, steps=100, image_size=224, log_every=10, augment=False,
          device='cuda', workers_count=10, model_parallel=None):
    """``steps`` SGD steps (lr 0.1, momentum 0.9) of ResNet-50 (bf16 on the
    card, f32 on the CPU); returns ``(state, losses)``. With ``augment``
    the loader stages a canvas of ``image_size * 8 // 7`` (the 256/224
    ratio) for the random resized crop to sample from; stored images must
    be at least that big. ``model_parallel`` (on every rank of a started
    process group) trains on the mesh of the module docstring, with
    ``batch_size`` the global batch."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == 'cuda' else torch.float32
    mesh = None
    if model_parallel is not None:
        import torch.distributed as dist
        from petastorm_tpu_torch.parallel import make_mesh
        mesh = make_mesh({'data': dist.get_world_size() // model_parallel,
                          'model': model_parallel}, device=device.type)
    model = init_flax_like(ResNet50(num_classes=1000, dtype=dtype, device=device),
                           torch.Generator().manual_seed(0))
    state = create_train_state(model.to(memory_format=torch.channels_last), learning_rate=0.1,
                               mesh=mesh)
    step_fn = make_train_step(mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(42)

    def preprocess(images_u8):
        if augment:
            return imagenet_train_augment(images_u8, generator, image_size, image_size, dtype=dtype)
        return images_u8.float() / 255.0

    canvas = image_size * 8 // 7 if augment else image_size
    losses, times = [], []
    with make_pod_reader(dataset_url, reader_factory=make_reader, mesh=mesh,
                         pod_shard=None if mesh else (0, 1), schema_fields=['image', 'label'],
                         num_epochs=None, workers_count=workers_count, shuffle_row_groups=True,
                         seed=0, deterministic=mesh is not None) as reader:
        with TorchLoader(reader, batch_size, device=device, mesh=mesh,
                         shape_policies={'image': CropTo((canvas, canvas, 3))}) as loader:
            prev = time.perf_counter()
            for step, batch in enumerate(loader, 1):
                metrics = step_fn(state, preprocess(batch.image), batch.label)
                losses.append(float(metrics['loss']))       # waits for the step
                now = time.perf_counter()
                times.append(now - prev)
                prev = now
                if step % log_every == 0:
                    print('step {}: loss {:.4f} | {:.1f} img/s'.format(
                        step, losses[-1], batch_size / np.mean(times[-log_every:])))
                if step >= steps:
                    break
    return state, losses


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--dataset-url', default='file:///tmp/imagenet_dataset_torch')
    parser.add_argument('--generate', action='store_true', help='write a synthetic store first')
    parser.add_argument('--batch-size', type=int, default=256)
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--image-size', type=int, default=224)
    parser.add_argument('--augment', action='store_true',
                        help='on-device Inception augmentation (random resized crop, flip, '
                             'color jitter)')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--model-parallel', type=int, default=None,
                        help="split the head over a 'model' axis of this size (run under "
                             'torchrun: one process a GPU, the batch global)')
    args = parser.parse_args()
    if args.model_parallel is None:
        if args.generate:
            generate_synthetic(args.dataset_url, ragged=32)
        train(args.dataset_url, args.batch_size, args.steps, args.image_size,
              augment=args.augment, device=args.device)
    else:
        from petastorm_tpu_torch.parallel.launch import init_from_env
        with init_from_env(args.device) as device:
            train(args.dataset_url, args.batch_size, args.steps, args.image_size,
                  augment=args.augment, device=device, model_parallel=args.model_parallel)
