"""Store interop and reader parity: a store written by either package is
read by the other, and the port's ``make_tensor_reader`` delivers the same
blocks as the JAX package's.

PNG stores are lossless, so blocks are compared bit for bit by CRC32 of
each field. JPEG stores decode through the same native C++ codec in both
packages (the port's own copy of it) and are compared bit for bit too; the
port's OpenCV fallback (where the native codec does not build) stays within
2 levels of the native decode.
"""

import zlib

import numpy as np
import pytest

from petastorm_tpu import make_tensor_reader as jax_make_tensor_reader
from petastorm_tpu.codecs import (CompressedImageCodec as JaxImageCodec,
                                  NdarrayCodec as JaxNdarrayCodec, ScalarCodec as JaxScalarCodec)
from petastorm_tpu.etl.writer import write_dataset as jax_write_dataset
from petastorm_tpu.unischema import Unischema as JaxUnischema, UnischemaField as JaxField
from petastorm_tpu_torch import (CompressedImageCodec, NdarrayCodec, ScalarCodec, Unischema,
                                 UnischemaField, get_schema, make_tensor_reader, write_dataset)
from petastorm_tpu_torch.storage import ParquetStore

ROWS, PER_GROUP = 40, 8


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    for i in range(ROWS):
        yield {'id': i,
               'image': rng.integers(0, 256, (12, 16, 3), dtype=np.uint8),
               'vec': rng.normal(size=(4,)).astype(np.float32)}


def _jax_schema(image_codec):
    return JaxUnischema('InteropSchema', [
        JaxField('id', np.int64, (), JaxScalarCodec(np.int64)),
        JaxField('image', np.uint8, (12, 16, 3), JaxImageCodec(image_codec, 90)),
        JaxField('vec', np.float32, (4,), JaxNdarrayCodec()),
    ])


def _port_schema(image_codec):
    return Unischema('InteropSchema', [
        UnischemaField('id', np.int64, (), ScalarCodec(np.int64)),
        UnischemaField('image', np.uint8, (12, 16, 3), CompressedImageCodec(image_codec, 90)),
        UnischemaField('vec', np.float32, (4,), NdarrayCodec()),
    ])


def _write(tmp_path, writer, image_codec):
    url = 'file://' + str(tmp_path / '{}-{}'.format(writer, image_codec))
    if writer == 'jax':
        jax_write_dataset(url, _jax_schema(image_codec), _rows(), rows_per_row_group=PER_GROUP)
    else:
        write_dataset(url, _port_schema(image_codec), _rows(), rows_per_row_group=PER_GROUP)
    return url


def _chunks(factory, url, **kwargs):
    """Every chunk, as a dict of numpy blocks, in delivery order."""
    kwargs.setdefault('shuffle_row_groups', False)
    kwargs.setdefault('workers_count', 1)
    with factory(url, reader_pool_type='thread', **kwargs) as reader:
        return [{name: np.asarray(getattr(chunk, name)) for name in chunk._fields}
                for chunk in reader]


def _crc(chunks):
    return [{name: (block.dtype.str, block.shape, zlib.crc32(np.ascontiguousarray(block).tobytes()))
             for name, block in chunk.items()} for chunk in chunks]


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_png_store_reads_bit_identical_in_both_packages(tmp_path, writer):
    url = _write(tmp_path, writer, 'png')
    port_chunks = _chunks(make_tensor_reader, url)
    assert _crc(port_chunks) == _crc(_chunks(jax_make_tensor_reader, url))
    assert len(port_chunks) == ROWS // PER_GROUP
    want = list(_rows())
    ids = np.concatenate([c['id'] for c in port_chunks])
    np.testing.assert_array_equal(ids, np.arange(ROWS))
    np.testing.assert_array_equal(np.concatenate([c['image'] for c in port_chunks]),
                                  np.stack([r['image'] for r in want]))
    np.testing.assert_array_equal(np.concatenate([c['vec'] for c in port_chunks]),
                                  np.stack([r['vec'] for r in want]))


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_jpeg_store_decodes_within_two_levels(tmp_path, writer):
    url = _write(tmp_path, writer, 'jpeg')
    port_chunks = _chunks(make_tensor_reader, url)
    jax_chunks = _chunks(jax_make_tensor_reader, url)
    assert len(port_chunks) == len(jax_chunks)
    for ours, theirs in zip(port_chunks, jax_chunks):
        np.testing.assert_array_equal(ours['id'], theirs['id'])
        np.testing.assert_array_equal(ours['vec'], theirs['vec'])
        diff = np.abs(ours['image'].astype(np.int16) - theirs['image'].astype(np.int16))
        assert ours['image'].dtype == np.uint8 and int(diff.max()) <= 2


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_jpeg_store_reads_bit_identical_through_the_native_codec(tmp_path, writer):
    """Both packages write the same JPEG bytes and decode the same pixels."""
    url = _write(tmp_path, writer, 'jpeg')
    other = _write(tmp_path, 'port' if writer == 'jax' else 'jax', 'jpeg')
    port_chunks = _chunks(make_tensor_reader, url)
    assert _crc(port_chunks) == _crc(_chunks(jax_make_tensor_reader, url))
    assert _crc(port_chunks) == _crc(_chunks(make_tensor_reader, other))


def test_jpeg_store_opencv_fallback_within_two_levels(tmp_path, monkeypatch):
    from petastorm_tpu_torch import codecs
    url = _write(tmp_path, 'jax', 'jpeg')
    native_chunks = _chunks(make_tensor_reader, url)
    monkeypatch.setattr(codecs, '_native_image', lambda: None)
    cv2_chunks = _chunks(make_tensor_reader, url)
    assert len(cv2_chunks) == len(native_chunks)
    for ours, theirs in zip(cv2_chunks, native_chunks):
        np.testing.assert_array_equal(ours['id'], theirs['id'])
        diff = np.abs(ours['image'].astype(np.int16) - theirs['image'].astype(np.int16))
        assert ours['image'].dtype == np.uint8 and int(diff.max()) <= 2


def test_schema_round_trips_between_packages(tmp_path):
    url = _write(tmp_path, 'jax', 'png')
    schema = get_schema(ParquetStore(url))
    assert schema.to_json() == _jax_schema('png').to_json()
    url = _write(tmp_path, 'port', 'jpeg')
    from petastorm_tpu.etl.dataset_metadata import get_schema_from_dataset_url
    assert get_schema_from_dataset_url(url).to_json() == _port_schema('jpeg').to_json()


def test_seeded_row_group_order_matches_jax_over_epochs(tmp_path):
    url = _write(tmp_path, 'port', 'png')

    def order(factory):
        return [int(c['id'][0]) // PER_GROUP for c in
                _chunks(factory, url, shuffle_row_groups=True, seed=5, num_epochs=3)]

    ours = order(make_tensor_reader)
    assert ours == order(jax_make_tensor_reader)
    groups = ROWS // PER_GROUP
    assert len(ours) == 3 * groups
    for epoch in range(3):   # every epoch covers every row-group once
        assert sorted(ours[epoch * groups:(epoch + 1) * groups]) == list(range(groups))
    assert ours[:groups] != sorted(ours[:groups])     # actually shuffled


def test_cur_shard_partitions_row_groups_like_jax(tmp_path):
    url = _write(tmp_path, 'port', 'png')
    seen = []
    for shard in range(3):
        ids = sorted(int(i) for c in _chunks(make_tensor_reader, url, cur_shard=shard,
                                             shard_count=3) for i in c['id'])
        theirs = sorted(int(i) for c in _chunks(jax_make_tensor_reader, url, cur_shard=shard,
                                                shard_count=3) for i in c['id'])
        assert ids == theirs
        seen.extend(ids)
    assert sorted(seen) == list(range(ROWS))    # disjoint and complete


def test_schema_fields_view_and_errors(tmp_path):
    url = _write(tmp_path, 'port', 'png')
    chunks = _chunks(make_tensor_reader, url, schema_fields=['id', 'im.*'])
    assert sorted(chunks[0]) == ['id', 'image']
    with pytest.raises(ValueError, match='matched no fields'):
        make_tensor_reader(url, schema_fields=['nope'])
    with pytest.raises(IOError, match='does not exist'):
        make_tensor_reader('file://' + str(tmp_path / 'missing'))
    with pytest.raises(ValueError, match='thread'):
        make_tensor_reader(url, reader_pool_type='processes')


def test_worker_error_surfaces_in_consumer(tmp_path, monkeypatch):
    url = _write(tmp_path, 'port', 'png')
    row_groups = ParquetStore.row_groups

    def with_a_bad_piece(store):
        pieces = row_groups(store)
        pieces[1].row_group = 999               # an out-of-range row-group
        return pieces

    # The reader starts its workers as it is built: the bad piece must be
    # there before the first read, not patched into a live reader.
    monkeypatch.setattr(ParquetStore, 'row_groups', with_a_bad_piece)
    reader = make_tensor_reader(url, workers_count=2)
    with pytest.raises(Exception):
        for _ in reader:
            pass
    reader.stop()
    reader.join()
