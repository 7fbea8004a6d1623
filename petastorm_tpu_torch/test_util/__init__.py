"""Testing utilities for downstream users (parity: reference ``petastorm/test_util/``)."""

from petastorm_tpu_torch.test_util.reader_mock import ReaderMock  # noqa: F401
