"""The wire-format helpers of ``r2d2_tpu/replay/block.py`` that the
session tier's wire (``serving/wire.py``) is built from: the shared CRC
convention and the ``(name, shape, dtype)`` slot layout.  Copied
byte-for-byte in behaviour, so a frame the port encodes is the frame the
JAX package encodes.  ``Block``, ``LocalBuffer`` and the slot specs wait
for the training slice.
"""
from __future__ import annotations

import zlib
from typing import Tuple

import numpy as np

# The ONE CRC convention every channel shares: int64 header words first,
# then the payload arrays in their declared order, masked to 32 bits.
# The transport modules import it rather than restate it.
CRC_MASK = 0xFFFFFFFF


def payload_crc32(header, arrays) -> int:
    """CRC32 over ``header`` (a sequence of ints, hashed as int64 words —
    covering the shape/token metadata so a header/payload mismatch is
    caught too) followed by ``arrays`` (numpy views, hashed in order).

    Arrays hash through the buffer protocol, NOT ``.tobytes()``: the
    byte stream (and therefore the CRC) is identical, but tobytes
    copies the whole payload first — at the sharded replay plane's
    batch-response scale (tens of MB per RPC) that copy cost as much
    as the hash itself.  Non-contiguous views still pay one compaction
    copy (``ascontiguousarray``)."""
    c = zlib.crc32(np.asarray(list(header), np.int64).tobytes())
    for a in arrays:
        c = zlib.crc32(memoryview(np.ascontiguousarray(a)).cast("B"), c)
    return c & CRC_MASK


def slot_layout(spec) -> Tuple[int, dict]:
    """(slot_nbytes, {name: byte offset}) for a :func:`block_slot_spec`,
    every array 8-byte aligned so the shm views are properly aligned for
    their dtypes."""
    offsets, off = {}, 0
    for name, shape, dtype in spec:
        off = (off + 7) & ~7
        offsets[name] = off
        off += int(np.prod(shape)) * np.dtype(dtype).itemsize
    return (off + 7) & ~7, offsets


def slot_views(buf, spec, offsets: dict, slot_nbytes: int, slot: int) -> dict:
    """Numpy views of slot ``slot`` inside a shared-memory buffer — the
    same call serves the producer (writes) and the consumer (zero-copy
    reads)."""
    base = slot * slot_nbytes
    return {name: np.ndarray(shape, dtype=dtype, buffer=buf,
                             offset=base + offsets[name])
            for name, shape, dtype in spec}
