"""ReaderMock: a schema-driven fake Reader generating synthetic rows (no IO).

Parity: reference ``petastorm/test_util/reader_mock.py:19-65`` +
``schema_data_generator_example`` (``:68-82``). Lets downstream users test
training loops without a dataset.
"""

from petastorm_tpu_torch.generator import generate_datapoint


class ReaderMock(object):
    """Infinite iterator of synthetic rows matching a Unischema.

    :param schema: Unischema describing the rows.
    :param schema_data_generator: optional ``(schema, rng) -> dict`` override.
    """

    def __init__(self, schema, schema_data_generator=None, seed=0):
        import numpy as np

        self.schema = schema
        self._generator = schema_data_generator or generate_datapoint
        self._rng = np.random.default_rng(seed)
        self.last_row_consumed = False

    @property
    def batched_output(self):
        return False

    @property
    def ngram(self):
        return None

    @property
    def transformed_schema(self):
        return self.schema

    def __iter__(self):
        return self

    def __next__(self):
        row = self._generator(self.schema, self._rng)
        return self.schema.make_namedtuple(**row)

    next = __next__

    def stop(self):
        pass

    def join(self):
        pass

    @property
    def diagnostics(self):
        return {}

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False
