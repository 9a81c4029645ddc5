"""Session-tier wire format: length-framed CRC'd messages over a local
socket.

The session-serving frontier (``serving/server.py``) faces *external*
episodic clients, so its transport cannot be the training fabric's
preallocated shared-memory slabs — a client is any process that can open
a loopback TCP connection.  What DOES carry over from the fabric is the
integrity discipline every shm channel already shares
(``replay/block.py``): a message is header int64 words followed by fixed
-shape payload arrays, hashed by :func:`~r2d2_tpu_torch.replay.block.
payload_crc32` with the CRC written LAST — a torn or garbled frame shows
up as a mismatch at the receiver, which drops it (counted) instead of
acting on garbage.  The payload layout itself is described by the same
``(name, shape, dtype)`` spec tuples the slab channels use and laid out
by :func:`~r2d2_tpu_torch.replay.block.slot_layout`, so one vocabulary covers
every transport in the tree (the ``wire-format`` graftlint rule extends
to these names — a module speaking this protocol must import them from
here, never restate them).

Frame grammar (all little-endian):

- ``u32 length`` — byte length of the body that follows.
- body: ``HEADER_WORDS`` int64 words ``(kind, session_id, seq, aux)``,
  then the payload arrays of the kind's spec (8-byte aligned,
  ``slot_layout`` packing), then the ``u32`` CRC over header + arrays.

Kinds and their payloads:

- ``MSG_OPEN``   (client → server): admit ``session_id``.  No payload.
  ``aux`` unused.
- ``MSG_ACT``    (client → server): one env-step act request —
  ``session_request_spec`` payload (obs, last_action one-hot,
  last_reward).  ``aux`` bit 0 = episode reset (zero the
  session-resident hidden before acting: a session may span many
  episodes).
- ``MSG_CLOSE``  (client → server): episode/session complete.  No
  payload.
- ``MSG_RSP``    (server → client): the reply to any of the above.
  ``aux`` carries the status; an OK act reply carries the
  ``session_response_spec`` payload (the q row — greedy action is
  ``argmax``; ε-greedy stays client-side exactly as it stays fleet-side
  in the training serve plane), all other replies are payload-free.

Statuses (HTTP-flavoured so operators can read a client log cold):
``STATUS_OK`` 0, ``STATUS_SHED`` 429 (admission rejected — bounded
pending queue full, breaker open, or no evictable session slot),
``STATUS_GONE`` 410 (unknown / evicted session — the client must
re-open, never assume server state), ``STATUS_EXPIRED`` 408 (the
request sat past its deadline and was shed instead of served stale).
"""
from __future__ import annotations

import socket
import struct
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.replay.block import payload_crc32, slot_layout, slot_views

# message kinds (header word 0)
MSG_OPEN = 1
MSG_ACT = 2
MSG_CLOSE = 3
MSG_RSP = 4

# response statuses (header word 3 of a MSG_RSP)
STATUS_OK = 0
STATUS_EXPIRED = 408
STATUS_GONE = 410
STATUS_SHED = 429

# act-request aux bits
FLAG_RESET = 1

# body header: (kind, session_id, seq, aux) as int64 words
HEADER_WORDS = 4
_HEADER_BYTES = HEADER_WORDS * 8

# framing: u32 body length; a sanity bound so a desynced/garbled length
# word cannot make a reader allocate gigabytes
_LEN = struct.Struct("<I")
MAX_FRAME_BYTES = 16 * 1024 * 1024


class WireGarbled(Exception):
    """A frame arrived but failed its CRC32 integrity check."""


class WireClosed(Exception):
    """The peer closed the connection (EOF mid-stream included)."""


def session_request_spec(cfg: Config, action_dim: int):
    """(name, shape, dtype) of one act request's payload — the batched
    AgentState row the act fn consumes, minus hidden (session-resident,
    the whole point of the tier)."""
    return (
        ("obs", tuple(cfg.stored_obs_shape), np.uint8),
        ("last_action", (action_dim,), np.float32),
        ("last_reward", (1,), np.float32),
    )


def session_response_spec(cfg: Config, action_dim: int):
    """(name, shape, dtype) of one OK act reply's payload: the q row
    (greedy action = argmax; exploration stays client-side)."""
    return (("q", (action_dim,), np.float32),)


EMPTY_SPEC: Tuple = ()


def encode_frame(spec, header: Sequence[int],
                 fields: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    """One wire frame (length word included): header words, the spec's
    payload arrays, CRC last — the replay/block.py convention."""
    if len(header) != HEADER_WORDS:
        raise ValueError(f"header must be {HEADER_WORDS} words")
    nbytes, offsets = slot_layout(spec) if spec else (0, {})
    body = bytearray(_HEADER_BYTES + nbytes + 4)
    np.frombuffer(body, np.int64, HEADER_WORDS)[:] = header
    arrays = []
    if spec:
        views = slot_views(memoryview(body)[_HEADER_BYTES:
                                            _HEADER_BYTES + nbytes],
                           spec, offsets, nbytes, 0)
        for name, _, _ in spec:
            views[name][...] = fields[name]
        arrays = [views[name] for name, _, _ in spec]
    crc = payload_crc32(header, arrays)
    body[-4:] = np.uint32(crc).tobytes()
    return _LEN.pack(len(body)) + bytes(body)


def peek_kind(body: bytes) -> int:
    """The message kind of a framed body, read before the payload spec is
    known (the spec to decode with depends on it)."""
    if len(body) < _HEADER_BYTES + 4:
        raise WireGarbled(f"frame body too short ({len(body)} bytes)")
    return int(np.frombuffer(body, np.int64, 1)[0])


def decode_frame(spec, body: bytes) -> Tuple[Tuple[int, ...], dict]:
    """``(header words, payload views)`` of a frame body, CRC-verified.
    The views alias ``body`` — copy anything that must outlive it.
    Raises :class:`WireGarbled` on a size or CRC mismatch."""
    nbytes, offsets = slot_layout(spec) if spec else (0, {})
    want = _HEADER_BYTES + nbytes + 4
    if len(body) != want:
        raise WireGarbled(
            f"frame body is {len(body)} bytes, spec says {want}")
    header = tuple(int(w) for w in np.frombuffer(body, np.int64,
                                                 HEADER_WORDS))
    views = {}
    arrays = []
    if spec:
        views = slot_views(memoryview(body)[_HEADER_BYTES:
                                            _HEADER_BYTES + nbytes],
                           spec, offsets, nbytes, 0)
        arrays = [views[name] for name, _, _ in spec]
    crc = int(np.frombuffer(body, np.uint32, 1, len(body) - 4)[0])
    if crc != payload_crc32(header, arrays):
        raise WireGarbled(f"frame kind {header[0]} seq {header[2]} failed "
                          "CRC32")
    return header, views


def send_frame(sock: socket.socket, frame: bytes) -> None:
    """Blocking whole-frame send (``frame`` already carries its length
    word).  Callers serialise concurrent writers with their own lock."""
    sock.sendall(frame)


class FrameReader:
    """Incremental frame parser over a non-blocking-ish socket.

    ``poll()`` does one bounded ``recv`` (the socket's timeout governs
    the wait) and returns every COMPLETE frame body that has arrived —
    zero on a quiet poll, several under pipelining.  Raises
    :class:`WireClosed` on EOF, so a reader loop stays a simple
    poll-with-timeout / check-stop cycle (the ``bounded-wait``
    discipline).

    ``max_frame`` is the desync sanity bound: session traffic keeps the
    default; transports with bigger legitimate frames (the cross-host
    replay fabric's preassembled batch responses, replay/netwire.py)
    pass their layout-derived bound so the check stays tight."""

    def __init__(self, sock: socket.socket,
                 max_frame: int = MAX_FRAME_BYTES):
        self.sock = sock
        self.max_frame = int(max_frame)
        # bytes the LAST poll() recv'd (0 = quiet): drain loops use it
        # to tell "socket idle" from "mid-frame, keep pulling" — a poll
        # returns no frames in both cases
        self.last_chunk = 0
        self._buf = bytearray()

    def poll(self) -> list:
        try:
            chunk = self.sock.recv(1 << 16)
        except socket.timeout:
            self.last_chunk = 0
            return []
        except OSError:
            raise WireClosed("connection reset")
        if not chunk:
            raise WireClosed("peer closed")
        self.last_chunk = len(chunk)
        self._buf.extend(chunk)
        out = []
        while True:
            if len(self._buf) < _LEN.size:
                return out
            (n,) = _LEN.unpack_from(self._buf)
            if n > self.max_frame:
                raise WireGarbled(f"frame length {n} exceeds the "
                                  f"{self.max_frame}-byte bound — "
                                  "desynced stream")
            if len(self._buf) < _LEN.size + n:
                return out
            out.append(bytes(self._buf[_LEN.size:_LEN.size + n]))
            del self._buf[:_LEN.size + n]
