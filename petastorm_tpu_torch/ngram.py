"""NGram: windows of consecutive rows within a row-group, read by
``make_reader(schema_fields=NGram(...))`` (counterpart of
``petastorm_tpu/ngram.py``).

``fields`` maps each window offset to the fields read at that step. Rows
are sorted by the timestamp field, and a window is kept only where each
consecutive gap is at most ``delta_threshold``; ``timestamp_overlap=False``
steps a whole window at a time. Windows never cross a row-group. The
reader yields one dict ``{offset: namedtuple}`` per window.
"""

from petastorm_tpu_torch.unischema import UnischemaField, match_unischema_fields


class NGram(object):
    def __init__(self, fields, delta_threshold, timestamp_field, timestamp_overlap=True):
        """
        :param fields: ``{offset: [UnischemaField or regex str, ...]}``.
        :param delta_threshold: the largest gap allowed between consecutive
            timestamps inside one window (None: any).
        :param timestamp_field: the ``UnischemaField`` (or name) that orders rows.
        :param timestamp_overlap: if False, consecutive windows share no row.
        """
        if not isinstance(fields, dict) or not fields:
            raise ValueError('fields must be a non-empty dict of offset -> field list')
        for key, value in fields.items():
            if not isinstance(key, int):
                raise ValueError('NGram offsets must be ints, got {!r}'.format(key))
            if not isinstance(value, (list, tuple)):
                raise ValueError('NGram field lists must be lists, got {!r}'.format(value))
        self._fields = {k: list(v) for k, v in fields.items()}
        self._delta_threshold = delta_threshold
        self._timestamp_field = timestamp_field
        self.timestamp_overlap = timestamp_overlap
        self._resolved = all(isinstance(f, UnischemaField)
                             for v in self._fields.values() for f in v)

    @property
    def fields(self):
        return self._fields

    @property
    def delta_threshold(self):
        return self._delta_threshold

    @property
    def length(self):
        offsets = sorted(self._fields)
        return offsets[-1] - offsets[0] + 1

    @property
    def timestamp_field_name(self):
        if isinstance(self._timestamp_field, UnischemaField):
            return self._timestamp_field.name
        return self._timestamp_field

    def resolve_regex_field_names(self, schema):
        """Replace regex strings by the schema's fields they match."""
        if self._resolved:
            return
        for offset, field_list in self._fields.items():
            self._fields[offset] = match_unischema_fields(schema, field_list,
                                                          allow_empty_match=False)
        self._resolved = True

    def get_field_names_at_timestep(self, timestep):
        if timestep not in self._fields:
            return []
        return sorted(f.name if isinstance(f, UnischemaField) else f
                      for f in self._fields[timestep])

    def get_field_names_at_all_timesteps(self):
        names = {self.timestamp_field_name}
        for offset in self._fields:
            names.update(self.get_field_names_at_timestep(offset))
        return sorted(names)

    def get_schema_at_timestep(self, schema, timestep):
        """The schema view of the fields read at one offset."""
        names = [n for n in self.get_field_names_at_timestep(timestep) if n in schema.fields]
        return schema.create_schema_view(names)

    def form_ngram(self, data, schema):
        """Rows (dicts) -> windows ``{offset: row dict}``, in timestamp order."""
        ts_name = self.timestamp_field_name
        rows = sorted(data, key=lambda r: r[ts_name])
        offsets = sorted(self._fields)
        base = offsets[0]
        length = self.length
        windows = []
        i = 0
        while i + length <= len(rows):
            window_rows = rows[i:i + length]
            if self._delta_threshold is not None and not self._is_continuous(window_rows,
                                                                             ts_name):
                i += 1
                continue
            window = {}
            for offset in offsets:
                wanted = self.get_field_names_at_timestep(offset)
                window[offset] = {k: v for k, v in window_rows[offset - base].items()
                                  if k in wanted}
            windows.append(window)
            i += length if not self.timestamp_overlap else 1
        return windows

    def _is_continuous(self, window_rows, ts_name):
        return all(cur[ts_name] - prev[ts_name] <= self._delta_threshold
                   for prev, cur in zip(window_rows, window_rows[1:]))

    def make_namedtuple(self, schema, window):
        """A window of dicts -> ``{offset: namedtuple}``."""
        return {offset: self.get_schema_at_timestep(schema, offset).make_namedtuple(**fields)
                for offset, fields in window.items()}
