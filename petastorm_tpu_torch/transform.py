"""TransformSpec: a user function run inside the reader's workers
(counterpart of ``petastorm_tpu/transform.py``).

The per-row reader calls ``func`` on each row's dict; the tensor reader on
the dict of the chunk's column blocks (numpy in, numpy out). The schema
edits (``edit_fields``, ``removed_fields``, ``selected_fields``) keep the
output schema known before any row is read.
"""

from petastorm_tpu_torch.unischema import Unischema, UnischemaField


class TransformSpec(object):
    def __init__(self, func=None, edit_fields=None, removed_fields=None, selected_fields=None,
                 version=None):
        """
        :param func: called inside the worker: a row's dict (``make_reader``)
            or the chunk's dict of column blocks (``make_tensor_reader``) in,
            the same kind out.
        :param edit_fields: ``UnischemaField``s (or 4/5-tuples ``(name,
            dtype, shape, [codec,] nullable)``) added to or replaced in the
            output schema.
        :param removed_fields: names of fields that ``func`` removes.
        :param selected_fields: if set, the output schema keeps only these
            names (after the edits and removals).
        :param version: a tag of the caller's (str or int) recorded in batch
            provenance records: a function cannot be hashed, so the tag tells
            two trainings apart when only the transform changed.
        """
        self.func = func
        self.edit_fields = [self._as_field(f) for f in (edit_fields or [])]
        self.removed_fields = list(removed_fields or [])
        self.selected_fields = list(selected_fields) if selected_fields is not None else None
        self.version = version

    @staticmethod
    def _as_field(f):
        if isinstance(f, UnischemaField):
            return f
        if isinstance(f, (tuple, list)):
            if len(f) == 4:
                name, dtype, shape, nullable = f
                return UnischemaField(name, dtype, shape, None, nullable)
            if len(f) == 5:
                name, dtype, shape, codec, nullable = f
                return UnischemaField(name, dtype, shape, codec, nullable)
        raise TypeError('edit_fields entries must be UnischemaField or 4/5-tuples, '
                        'got {!r}'.format(f))


def transform_schema(schema, transform_spec):
    """The schema after ``transform_spec``: removals, then edits, then the
    selection."""
    fields = dict(schema.fields)
    for name in transform_spec.removed_fields:
        fields.pop(name, None)
    for f in transform_spec.edit_fields:
        fields[f.name] = f
    if transform_spec.selected_fields is not None:
        missing = [n for n in transform_spec.selected_fields if n not in fields]
        if missing:
            raise ValueError('selected_fields not present after transform: {}'.format(missing))
        fields = {n: fields[n] for n in transform_spec.selected_fields}
    return Unischema(schema.name, list(fields.values()))
