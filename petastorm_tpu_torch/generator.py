"""Synthetic datapoint generation from a Unischema.

The port's copy of ``petastorm_tpu/generator.py`` (reference
``petastorm/generator.py:21-47``): the same draws from the same ``rng``.
"""

import numpy as np


def generate_datapoint(schema, rng=None):
    """Random row dict compatible with ``schema`` (variable dims drawn 1..8)."""
    rng = rng if rng is not None else np.random.default_rng()
    row = {}
    for name, field in schema.fields.items():
        dtype = field.numpy_dtype
        shape = tuple(int(rng.integers(1, 9)) if d is None else d
                      for d in field.shape)
        if dtype.kind in ('U', 'S', 'O'):
            row[name] = 'random_string_{}'.format(int(rng.integers(0, 1000)))
        elif dtype.kind == 'b':
            row[name] = (rng.random(shape) > 0.5) if shape else bool(rng.integers(0, 2))
        elif dtype.kind in ('i', 'u'):
            info = np.iinfo(dtype)
            low, high = max(info.min, -1000), min(info.max, 1000)
            value = rng.integers(low, high + 1, size=shape or None)
            row[name] = value.astype(dtype) if shape else dtype.type(value)
        elif dtype.kind == 'f':
            value = rng.random(shape or None)
            row[name] = value.astype(dtype) if shape else dtype.type(value)
        elif dtype.kind == 'M':
            row[name] = np.datetime64('2020-01-01') + np.timedelta64(
                int(rng.integers(0, 10000)), 'm')
        else:
            raise ValueError('Cannot generate data for field {!r} dtype {}'.format(
                name, dtype))
    return row
