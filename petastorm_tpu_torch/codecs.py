"""Field codecs: how a tensor/scalar field is stored inside a Parquet cell.

Counterpart of ``petastorm_tpu/codecs.py:59-460``. The codec JSON specs
(``{'codec': name, ...}``) are the JAX package's, so stores interoperate.
Images go through OpenCV (else PIL); user-facing arrays are RGB, the cv2
BGR convention stays inside the codec (``petastorm_tpu/codecs.py:317``).
The JAX package's native C++ codec is not ported in this slice.
"""

import io

import numpy as np
import pyarrow as pa

from petastorm_tpu_torch.errors import DecodeFieldError, SchemaError

try:
    import cv2
except ImportError:  # pragma: no cover - environment without OpenCV
    cv2 = None

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
class CompressedImageCodec(DataframeColumnCodec):
    """png/jpeg image compression into a bytes cell (RGB or 2-D gray uint8)."""

    codec_name = 'compressed_image'

    def __init__(self, image_codec='png', quality=80):
        if image_codec not in ('png', 'jpeg', 'jpg'):
            raise ValueError('image_codec must be png or jpeg, got {!r}'.format(image_codec))
        self._format = 'jpeg' if image_codec in ('jpeg', 'jpg') else 'png'
        self._quality = int(quality)

    def encode(self, field, value):
        value = np.asarray(value)
        check_shape_compliance(field, value)
        _check_dtype(field, value)
        if self._format == 'jpeg' and value.dtype != np.uint8:
            raise ValueError('jpeg only supports uint8 (field {!r} is {})'.format(
                field.name, value.dtype))
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

    def decode(self, field, encoded):
        if any(dim is None for dim in field.shape):     # a ragged field: any size
            image = self._imdecode(field, encoded)
            try:
                check_shape_compliance(field, image)
            except ValueError as e:
                raise DecodeFieldError(str(e)) from e
            return image
        out = np.empty(field.shape, field.numpy_dtype)
        self.decode_into(field, encoded, out)
        return out

    def _imdecode(self, field, encoded):
        """One stream decoded into a new RGB (or 2-D gray) array."""
        if cv2 is not None:
            bgr = cv2.imdecode(np.frombuffer(encoded, dtype=np.uint8), self._cv2_flags(field))
            if bgr is None:
                raise DecodeFieldError('cv2.imdecode failed for field {!r}'.format(field.name))
            return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB) if bgr.ndim == 3 else bgr
        from PIL import Image
        img = Image.open(io.BytesIO(encoded))
        if len(field.shape) == 3:
            img = img.convert('RGB')
        return np.asarray(img)

    @staticmethod
    def _cv2_flags(field):
        flags = cv2.IMREAD_UNCHANGED if len(field.shape) == 2 else cv2.IMREAD_COLOR
        if field.numpy_dtype != np.uint8:
            flags |= cv2.IMREAD_ANYDEPTH
        return flags

    def decode_into(self, field, encoded, out):
        """Decode one stream straight into ``out`` (a slot of a block)."""
        if cv2 is not None:
            bgr = cv2.imdecode(np.frombuffer(encoded, dtype=np.uint8), self._cv2_flags(field))
            if bgr is None:
                raise DecodeFieldError('cv2.imdecode failed for field {!r}'.format(field.name))
            if bgr.shape != out.shape:
                raise DecodeFieldError('Image of field {!r} decodes to shape {}, declared {}'.format(
                    field.name, bgr.shape, out.shape))
            if bgr.ndim == 3:
                cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB, dst=out)
            else:
                out[...] = bgr
            return
        arr = self._imdecode(field, encoded)
        if arr.shape != out.shape:
            raise DecodeFieldError('Image of field {!r} decodes to shape {}, declared {}'.format(
                field.name, arr.shape, out.shape))
        out[...] = arr

    def arrow_type(self):
        return pa.binary()

    def to_json(self):
        return {'codec': self.codec_name, 'image_codec': self._format, 'quality': self._quality}

    @classmethod
    def from_json(cls, spec):
        return cls(spec.get('image_codec', 'png'), spec.get('quality', 80))

    def __repr__(self):
        return 'CompressedImageCodec({!r}, quality={})'.format(self._format, self._quality)
