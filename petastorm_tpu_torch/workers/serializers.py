"""Payload serializers of the process pools (counterpart of
``petastorm_tpu/workers/serializers.py:13-32``).

A serializer turns a published result into a list of *frames* and back.
:class:`PickleSerializer` is pickle protocol 5 with the large buffers out
of band: the first frame is the pickle stream, every numpy block of 64 KiB
or more is a frame of its own that the transport moves without a copy
into a ``bytes`` (zmq sends it as a message part; the shm ring's worker
copies it straight into the ring and the consumer straight out of it into
the one buffer the arrays then view). Every worker of the port publishes
one payload, a dict of column blocks with its chunk key, lineage segment
and deterministic tag, so every pool kind carries it alike and resume,
resequencing and provenance stay one code path. :class:`ArrowTableSerializer`
carries a ``pa.Table`` as an Arrow IPC stream, for a worker that publishes
tables (the JAX package's batch reader does; the port's converts its
tables to numpy in the worker).
"""

import pickle

import pyarrow as pa

#: Buffers smaller than this stay inside the pickle stream.
OUT_OF_BAND_MIN_BYTES = 1 << 16


class PickleSerializer(object):
    def serialize(self, obj):
        """``[pickle stream, out-of-band buffer, ...]``."""
        buffers = []

        def out_of_band(picklebuffer):
            view = picklebuffer.raw()
            if view.nbytes < OUT_OF_BAND_MIN_BYTES:
                return True         # true: in band
            buffers.append(view)
            return False

        return [pickle.dumps(obj, protocol=5, buffer_callback=out_of_band)] + buffers

    def deserialize(self, frames):
        """The object of ``frames`` (any buffers); its arrays view the
        out-of-band frames."""
        return pickle.loads(frames[0], buffers=frames[1:])


class ArrowTableSerializer(object):
    """A ``pa.Table`` as one frame of the Arrow IPC stream format."""

    def serialize(self, table):
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, table.schema) as writer:
            writer.write_table(table)
        return [memoryview(sink.getvalue())]

    def deserialize(self, frames):
        with pa.ipc.open_stream(pa.py_buffer(frames[0])) as reader:
            return reader.read_all()
