"""Field codecs: how a tensor/scalar field is stored inside a Parquet cell.

Counterpart of ``petastorm_tpu/codecs.py:59-615``. The codec JSON specs
(``{'codec': name, ...}``) are the JAX package's, so stores interoperate.

Images go through the port's copy of the JAX package's native C++ codec
(:mod:`~petastorm_tpu_torch.native.image`), so both packages encode the
same bytes and decode the same pixels. When it does not build they go
through OpenCV (else PIL); the reason is kept (:func:`decoder_info`), so a
reader's stats say which decoder ran.
User-facing arrays are RGB; the cv2 BGR convention stays inside the codec.

The worker fast path is :func:`decode_image_batch_into`: one native call per
(row-group, field), fanned over the process's decode-thread budget
(:mod:`~petastorm_tpu_torch.decode_budget`), each image decoded straight
into its slot of the block. ``PSTT_DECODE_PATH=scalar`` takes one call per
image instead, with identical output. Each batched call bumps
``pst_decode_batch_calls_total`` and ``pst_decode_batch_images_total``, and
its per-slot fallbacks ``pst_decode_batch_fallbacks_total``
(``petastorm_tpu/codecs.py:581-616``); the ``decode-corrupt-batch`` fault
site poisons one slot of a call (``:545``).
"""

import io
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.errors import DecodeFieldError, SchemaError

try:
    import cv2
except ImportError:  # pragma: no cover - environment without OpenCV
    cv2 = None

def _native_image():
    """The port's native codec module, or None when it did not build."""
    from petastorm_tpu_torch.native import image as native_image
    return native_image if native_image.available() else None


def decoder_info():
    """Which image decoder runs in this process: ``{'decoder': 'native' |
    'cv2' | 'pil', 'native_error': the native build's error, or None}``."""
    if _native_image() is not None:
        return {'decoder': 'native', 'native_error': None}
    from petastorm_tpu_torch.native import image as native_image
    return {'decoder': 'cv2' if cv2 is not None else 'pil',
            'native_error': native_image.load_error()}

_CODEC_REGISTRY = {}


def register_codec(cls):
    _CODEC_REGISTRY[cls.codec_name] = cls
    return cls


def codec_from_json(spec):
    """Reconstruct a codec from its JSON dict (``{'codec': name, ...}``)."""
    if spec is None:
        return None
    name = spec.get('codec')
    if name not in _CODEC_REGISTRY:
        raise SchemaError('Unknown codec {!r}; known: {}'.format(name, sorted(_CODEC_REGISTRY)))
    return _CODEC_REGISTRY[name].from_json(spec)


def check_shape_compliance(field, value):
    """Raise if ``value``'s shape is incompatible with ``field.shape``
    (``None`` entries are wildcards)."""
    expected, actual = field.shape, np.shape(value)
    if len(expected) != len(actual) or any(
            want is not None and want != got for want, got in zip(expected, actual)):
        raise ValueError('Field {!r} shape mismatch: declared {}, got {}'.format(
            field.name, expected, actual))


def _check_dtype(field, value):
    if value.dtype != field.numpy_dtype:
        raise ValueError('Field {!r} expects dtype {}, got {}'.format(
            field.name, field.numpy_dtype, value.dtype))


class DataframeColumnCodec(object):
    """Codec interface: ``encode`` makes the Parquet cell, ``decode`` the
    user-facing numpy value."""

    codec_name = None

    def encode(self, field, value):
        raise NotImplementedError

    def decode(self, field, encoded):
        raise NotImplementedError

    def arrow_type(self):
        raise NotImplementedError

    def to_json(self):
        return {'codec': self.codec_name}

    @classmethod
    def from_json(cls, spec):
        return cls()

    def __eq__(self, other):
        return type(self) is type(other) and self.to_json() == other.to_json()

    def __hash__(self):
        return hash(repr(sorted(self.to_json().items())))

    def __repr__(self):
        return '{}()'.format(type(self).__name__)


_NUMPY_TO_ARROW_SCALAR = {
    np.dtype('bool'): pa.bool_(),
    np.dtype('int8'): pa.int8(),
    np.dtype('uint8'): pa.uint8(),
    np.dtype('int16'): pa.int16(),
    np.dtype('uint16'): pa.uint16(),
    np.dtype('int32'): pa.int32(),
    np.dtype('uint32'): pa.uint32(),
    np.dtype('int64'): pa.int64(),
    np.dtype('uint64'): pa.uint64(),
    np.dtype('float16'): pa.float16(),
    np.dtype('float32'): pa.float32(),
    np.dtype('float64'): pa.float64(),
}


@register_codec
class ScalarCodec(DataframeColumnCodec):
    """A scalar stored natively in a typed Parquet column."""

    codec_name = 'scalar'

    def __init__(self, numpy_dtype):
        self._dtype = np.dtype(numpy_dtype)

    def encode(self, field, value):
        if np.ndim(value) != 0:
            raise ValueError('ScalarCodec field {!r} got non-scalar value of shape {}'.format(
                field.name, np.shape(value)))
        if self._dtype.kind in 'SUO':
            return str(value)
        return self._dtype.type(np.asarray(value).item()).item()

    def decode(self, field, encoded):
        return field.numpy_dtype.type(encoded)

    def arrow_type(self):
        if self._dtype.kind in 'SUO':
            return pa.string()
        arrow = _NUMPY_TO_ARROW_SCALAR.get(self._dtype)
        if arrow is None:
            raise SchemaError('ScalarCodec does not support numpy dtype {}'.format(self._dtype))
        return arrow

    def to_json(self):
        return {'codec': self.codec_name, 'dtype': self._dtype.str}

    @classmethod
    def from_json(cls, spec):
        return cls(np.dtype(spec['dtype']))

    def __repr__(self):
        return 'ScalarCodec({})'.format(self._dtype)


@register_codec
class NdarrayCodec(DataframeColumnCodec):
    """An ndarray serialized with ``np.save`` into a bytes cell."""

    codec_name = 'ndarray'

    def encode(self, field, value):
        value = np.asarray(value)
        check_shape_compliance(field, value)
        _check_dtype(field, value)
        memfile = io.BytesIO()
        np.save(memfile, value, allow_pickle=False)
        return memfile.getvalue()

    def decode(self, field, encoded):
        return np.load(io.BytesIO(encoded), allow_pickle=False)

    def arrow_type(self):
        return pa.binary()


@register_codec
class CompressedNdarrayCodec(DataframeColumnCodec):
    """An ndarray zlib-compressed with ``np.savez_compressed`` into a bytes
    cell (``petastorm_tpu/codecs.py:289-316``; the archive holds one entry,
    ``arr``)."""

    codec_name = 'compressed_ndarray'

    def encode(self, field, value):
        value = np.asarray(value)
        check_shape_compliance(field, value)
        _check_dtype(field, value)
        memfile = io.BytesIO()
        np.savez_compressed(memfile, arr=value)
        return memfile.getvalue()

    def decode(self, field, encoded):
        with np.load(io.BytesIO(encoded), allow_pickle=False) as archive:
            return archive['arr']

    def arrow_type(self):
        return pa.binary()


@register_codec
class CompressedImageCodec(DataframeColumnCodec):
    """png/jpeg image compression into a bytes cell (RGB or 2-D gray)."""

    codec_name = 'compressed_image'

    def __init__(self, image_codec='png', quality=80):
        if image_codec not in ('png', 'jpeg', 'jpg'):
            raise ValueError('image_codec must be png or jpeg, got {!r}'.format(image_codec))
        self._format = 'jpeg' if image_codec in ('jpeg', 'jpg') else 'png'
        self._quality = int(quality)

    @property
    def image_codec(self):
        return self._format

    @property
    def quality(self):
        return self._quality

    def encode(self, field, value):
        value = np.asarray(value)
        check_shape_compliance(field, value)
        _check_dtype(field, value)
        if self._format == 'jpeg' and value.dtype != np.uint8:
            raise ValueError('jpeg only supports uint8 (field {!r} is {})'.format(
                field.name, value.dtype))
        native = _native_image()
        if native is not None:
            if self._format == 'jpeg':
                return native.encode_jpeg(value, quality=self._quality)
            return native.encode_png(value)
        if cv2 is not None:
            bgr = value
            if value.ndim == 3:
                if value.shape[2] != 3:
                    raise ValueError('Image field {!r} must have 1 or 3 channels'.format(field.name))
                bgr = cv2.cvtColor(value, cv2.COLOR_RGB2BGR)
            params = [cv2.IMWRITE_JPEG_QUALITY, self._quality] if self._format == 'jpeg' else []
            ok, contents = cv2.imencode('.' + self._format, bgr, params)
            if not ok:
                raise RuntimeError('cv2.imencode failed for field {!r}'.format(field.name))
            return contents.tobytes()
        from PIL import Image
        buf = io.BytesIO()
        kwargs = {'quality': self._quality} if self._format == 'jpeg' else {}
        Image.fromarray(value).save(buf, format=self._format.upper(), **kwargs)
        return buf.getvalue()

    @staticmethod
    def conform_channels(arr, field):
        """The native decoder returns a stream's own channels; an (H, W, 3)
        field takes exactly 3 (gray repeated, alpha dropped) and a 2-D field
        drops a unit channel axis, as OpenCV's flags give them
        (``petastorm_tpu/codecs.py:365-383``)."""
        want = field.shape
        if len(want) == 3 and want[2] == 3:
            if arr.ndim == 2:
                return np.repeat(arr[:, :, None], 3, axis=2)
            if arr.ndim == 3 and arr.shape[2] == 1:
                return np.repeat(arr, 3, axis=2)
            if arr.ndim == 3 and arr.shape[2] == 4:
                return np.ascontiguousarray(arr[:, :, :3])
        elif len(want) == 2 and arr.ndim == 3 and arr.shape[2] == 1:
            return arr[:, :, 0]
        return arr

    def decode(self, field, encoded):
        """One stream to an array of the field's shape (``None`` dims take
        any size); a stream of another shape raises ``DecodeFieldError``."""
        native = _native_image()
        if native is not None:
            try:
                image = self.conform_channels(native.decode_image(bytes(encoded)), field)
            except ValueError as e:     # the native error string, as the JAX codec raises it
                raise DecodeFieldError(str(e)) from e
        else:
            image = self._imdecode(field, encoded)
        try:
            check_shape_compliance(field, image)
        except ValueError as e:
            raise DecodeFieldError(str(e)) from e
        return image

    def _imdecode(self, field, encoded):
        """One stream decoded by OpenCV (else PIL) into a new RGB (or 2-D
        gray) array."""
        if cv2 is not None:
            flags = cv2.IMREAD_UNCHANGED if len(field.shape) == 2 else cv2.IMREAD_COLOR
            if field.numpy_dtype != np.uint8:
                flags |= cv2.IMREAD_ANYDEPTH
            bgr = cv2.imdecode(np.frombuffer(encoded, dtype=np.uint8), flags)
            if bgr is None:
                raise DecodeFieldError('cv2.imdecode failed for field {!r}'.format(field.name))
            return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB) if bgr.ndim == 3 else bgr
        from PIL import Image
        img = Image.open(io.BytesIO(encoded))
        if len(field.shape) == 3:
            img = img.convert('RGB')
        return np.asarray(img)

    def arrow_type(self):
        return pa.binary()

    def to_json(self):
        return {'codec': self.codec_name, 'image_codec': self._format, 'quality': self._quality}

    @classmethod
    def from_json(cls, spec):
        return cls(spec.get('image_codec', 'png'), spec.get('quality', 80))

    def __repr__(self):
        return 'CompressedImageCodec({!r}, quality={})'.format(self._format, self._quality)


# --------------------------------------------------------------------------
# batched image-column decode (the worker fast path)
# --------------------------------------------------------------------------

#: ``scalar`` forces one native call per image; ``batched`` (or ``auto``, or
#: unset) keeps one call per (row-group, field). Read at each call, so a
#: process may flip it between readers (``petastorm_tpu/codecs.py:444-480``).
DECODE_PATH_ENV = 'PSTT_DECODE_PATH'


def decode_path():
    """``'batched'`` (the default) or ``'scalar'`` from ``PSTT_DECODE_PATH``;
    any other value raises."""
    raw = os.environ.get(DECODE_PATH_ENV, '').strip().lower()
    if raw in ('', 'auto', 'batched'):
        return 'batched'
    if raw == 'scalar':
        return 'scalar'
    raise ValueError('{} must be "batched" or "scalar", got {!r}'.format(DECODE_PATH_ENV, raw))


def _resolve_decode_threads(decode_threads):
    """``None``: this worker's fair share of the process budget now."""
    if decode_threads is not None:
        return max(1, int(decode_threads))
    from petastorm_tpu_torch import decode_budget
    return decode_budget.get_budget().share()


def _decode_cell_into(out, i, field, codec, blob, native_error=None):
    """Stream ``i`` decoded on its own into ``out[i]``: the scalar path's
    body and the batched path's per-slot fallback, giving the same bytes as
    a batched slot. A stream of another shape raises, never broadcasts."""
    try:
        value = np.asarray(codec.decode(field, blob))
    except Exception as e:
        raise DecodeFieldError('Image {} of field {!r} failed to decode: {}'.format(
            i, field.name, e), native_error=native_error) from e
    if value.shape != out.shape[1:]:
        raise DecodeFieldError('Image {} of field {!r} decodes to shape {}, declared {}'.format(
            i, field.name, value.shape, tuple(field.shape)))
    out[i] = value


#: What the ``decode-corrupt-batch`` fault site puts in slot 0 of a batch.
_CORRUPT_BLOB = b'\xde\xad not-an-image \xbe\xef'


def _count_batch_call(n):
    from petastorm_tpu_torch import metrics
    metrics.counter('pst_decode_batch_calls_total',
                    'Batched native image decode calls (one per '
                    '(row-group, field) on the fast path)').inc()
    metrics.counter('pst_decode_batch_images_total',
                    'Images decoded through the batched native fast '
                    'path').inc(n)


def decode_image_batch_into(field, out, blob_fn, ptrs=None, lens=None, decode_threads=None,
                            fault_key=None):
    """Decode ``len(out)`` JPEG/PNG streams into the slots ``out[i]``.

    :param field: the image field (shape, dtype and codec).
    :param out: a C-contiguous ``[N, ...field.shape]`` block.
    :param blob_fn: ``i -> bytes`` of stream ``i``, called only for the
        scalar path and per-slot fallbacks.
    :param ptrs, lens: integer arrays of the streams' addresses and sizes
        (pointer math over an Arrow binary column's value buffer), so the
        batched call materializes no ``bytes``; built from ``blob_fn``
        when omitted.
    :param decode_threads: threads of the batched call, C++ ones (OpenCV's
        without the native codec); ``None``: the current fair share of
        ``PSTT_DECODE_THREADS``.
    :param fault_key: the row-group's key of the ``decode-corrupt-batch``
        fault site: when it fires, slot 0 gets a stream that is no image,
        so exactly this call (and its row-group) fails.

    Returns the number of per-slot fallbacks (0 on the pure fast path). A
    slot the batched call fails (an RGBA stream in an RGB slot, a gray
    stream in an RGB field, a corrupt stream) is decoded again on its own;
    a stream that fails there too raises ``DecodeFieldError`` carrying the
    native error string (``native_error``). ``PSTT_DECODE_PATH=scalar``, a
    missing native codec and a non-uint8 field take the per-image loop,
    with identical output; without the native codec the batched path runs
    that loop on ``decode_threads`` threads (OpenCV releases the GIL), and
    counts as a batched call.
    """
    n = len(out)
    if n == 0:
        return 0
    codec = field.resolved_codec()
    poisoned = False
    if fault_key is not None:
        from petastorm_tpu_torch.faults import get_injector
        if get_injector().should_fire('decode-corrupt-batch', key=fault_key):
            poisoned = True
            real_blob_fn = blob_fn
            blob_fn = lambda i: _CORRUPT_BLOB if i == 0 else real_blob_fn(i)  # noqa: E731
    native = _native_image()
    batched = decode_path() == 'batched'
    threads = _resolve_decode_threads(decode_threads)
    if native is None and batched and n > 1 and threads > 1:
        # The OpenCV fallback spends the same threads: imdecode releases
        # the GIL. In index order, so the first failure is the loop's.
        with ThreadPoolExecutor(min(n, threads), thread_name_prefix='pstt-decode') as pool:
            for _ in pool.map(lambda i: _decode_cell_into(out, i, field, codec, blob_fn(i)),
                              range(n)):
                pass
        _count_batch_call(n)
        return 0
    if native is None or not batched or out.dtype != np.uint8:
        for i in range(n):
            _decode_cell_into(out, i, field, codec, blob_fn(i))
        if native is None and batched:
            _count_batch_call(n)    # the OpenCV route of the batched path
        return 0
    keepalive = None
    if ptrs is None or lens is None:
        keepalive = [np.frombuffer(blob_fn(i), dtype=np.uint8) for i in range(n)]
        ptrs = [view.ctypes.data for view in keepalive]    # the views alias the bytes
        lens = [len(view) for view in keepalive]
    elif poisoned:
        keepalive = [np.frombuffer(_CORRUPT_BLOB, dtype=np.uint8)]
        ptrs = np.array(ptrs, dtype=np.int64)
        lens = np.array(lens, dtype=np.int64)
        ptrs[0] = keepalive[0].ctypes.data
        lens[0] = len(_CORRUPT_BLOB)
    results, chs, hs, ws = native.decode_batch_into(ptrs, lens, out, num_threads=threads)
    del keepalive
    _count_batch_call(n)
    want_ch = field.shape[2] if len(field.shape) == 3 else 1
    want_h, want_w = field.shape[0], field.shape[1]
    fallbacks = 0
    for i in range(n):
        if results[i] != 0:
            fallbacks += 1
            _decode_cell_into(out, i, field, codec, blob_fn(i),
                              native_error=native.decode_error_message(results[i]))
            continue
        if hs[i] != want_h or ws[i] != want_w:
            raise DecodeFieldError('Image {} of field {!r} decodes to {}x{}, declared {}x{}'
                                   .format(i, field.name, hs[i], ws[i], want_h, want_w))
        if chs[i] != want_ch:
            # A gray stream in an RGB field filled part of its slot.
            out[i] = CompressedImageCodec.conform_channels(native.decode_image(blob_fn(i)),
                                                           field)
            fallbacks += 1
    if fallbacks:
        from petastorm_tpu_torch import metrics
        metrics.counter('pst_decode_batch_fallbacks_total',
                        'Per-image fallback decodes after a batched call '
                        '(failed or channel-mismatched slots)').inc(fallbacks)
    return fallbacks
