"""Cross-host replay wire format: the shard RPC vocabulary over TCP.

Port of ``r2d2_tpu/replay/netwire.py``, whole.  The frames are byte for
byte the reference's, so a JAX shard server and a torch coordinator (or
the other way round) share one fabric.

The sharded replay plane's RPC vocabulary (block ingest, stratified
sample request/response, priority feedback, mass/stat gossip,
snapshot/drain control — parallel/replay_shards.py) re-expressed as
length-framed CRC'd messages so the shards can live on OTHER HOSTS
(parallel/replay_net.py drives it).
Nothing about the *content* changes: every payload spec here is DERIVED
from the shm plane's canonical slot specs (``replay/block.py``
``block_slot_spec`` / ``batch_slot_spec``), so the socket plane and the
shm plane can never drift field-for-field, and the framing reuses the
session tier's grammar verbatim (``serving/wire.py``: ``u32 length``,
``HEADER_WORDS`` int64 header words, payload arrays in ``slot_layout``
packing, CRC32 LAST over header + arrays via ``payload_crc32`` — one CRC
definition all the way down).

Header convention (the session tier's four int64 words, reinterpreted):
``(kind, epoch, seq, aux)``.

- ``kind`` — one of the ``NMSG_*`` constants below (numbered disjoint
  from the session tier's ``MSG_*`` so a frame delivered to the wrong
  port is unmistakably foreign).
- ``epoch`` — the shard's incarnation tag: the shm plane's
  *generation* made a wire word.  A shard server stamps its epoch into every frame it sends;
  the trainer stamps the epoch it believes the shard is in.  A mismatch
  means one side restarted/restored across the exchange — the receiver
  DROPS the frame and counts it (``epoch_drops``): stale priority
  feedback must never scribble on a restored ring, stale responses must
  never enter a batch.
- ``seq`` — per-link monotone request token (a retry supersedes).
- ``aux`` — kind-specific small scalar (shard id, row count, status).

Kinds:

- ``NMSG_HELLO``   (trainer → shard): attach request.  Payload
  ``net_hello_spec`` carries the geometry ``layout_token`` (a CRC over
  the derived frame layouts) and the shard id the trainer expects — a
  mis-wired endpoint or drifted config fails the handshake instead of
  garbling traffic.
- ``NMSG_WELCOME`` (shard → trainer): handshake reply; ``epoch`` is the
  shard's current epoch, ``aux`` the shard id (−1 = geometry/identity
  rejected, connection closes).
- ``NMSG_INGEST``  (trainer → shard): one routed block.  Payload
  ``net_ingest_spec`` = the shm block slot spec plus the shape header
  words that ride the metadata queue on the shm path.
- ``NMSG_SAMPLE_REQ`` (trainer → shard): stratified sample request;
  ``aux`` = rows wanted.  Payload-free.
- ``NMSG_SAMPLE_RSP`` (shard → trainer): the preassembled batch rows.
  Payload ``net_sample_response_spec`` = the shm sample slab minus the
  slab-only request/seq/CRC scalar words (the frame header and frame CRC
  carry those roles).
- ``NMSG_PRIO``    (trainer → shard): priority feedback for up to a
  batch of rows; ``aux`` = used rows.  Payload ``net_feedback_spec``.
- ``NMSG_STATS``   (shard → trainer): mass/stat gossip — the shm stats
  slab's float64 vector pushed over the wire on the shard's publish
  cadence; ``seq`` is the publish sequence the trainer-side
  CounterMerger folds across reconnects/respawns.
- ``NMSG_SAVE``    (trainer → shard): drain-then-save control
  (``net_save_spec``: snapshot path + the routed/feedback expectations
  the shard drains to before writing).
- ``NMSG_SAVE_RSP`` (shard → trainer): the shard's snapshot meta as
  JSON bytes (``net_save_response_spec``); ``aux`` 0 = ok.
"""
from __future__ import annotations

import json
from typing import Tuple

import numpy as np

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.replay.block import (
    batch_slot_spec,
    block_slot_spec,
    payload_crc32,
    slot_layout,
)
from r2d2_tpu_torch.serving.wire import HEADER_WORDS  # noqa: F401  (re-export:
# netwire frames use the session grammar's header geometry verbatim)

# message kinds (header word 0) — disjoint from serving/wire.py MSG_*
NMSG_HELLO = 16
NMSG_WELCOME = 17
NMSG_INGEST = 18
NMSG_SAMPLE_REQ = 19
NMSG_SAMPLE_RSP = 20
NMSG_PRIO = 21
NMSG_STATS = 22
NMSG_SAVE = 23
NMSG_SAVE_RSP = 24

# bounded string/JSON payload regions of the save control frames
SAVE_PATH_BYTES = 4096
SAVE_META_BYTES = 1 << 16


def net_hello_spec():
    """Attach-request payload: the geometry token + expected shard id."""
    return (("hello_token", (1,), np.int64),
            ("hello_shard", (1,), np.int64))


def net_ingest_spec(cfg: Config, action_dim: int):
    """One routed block as a frame payload: the canonical shm block slot
    spec (CRC word included — written by ``write_block`` exactly as on
    the shm path, a second integrity word under the frame CRC) plus the
    shape header that crosses the metadata queue on the shm transport."""
    return block_slot_spec(cfg, action_dim) + (
        ("ing_k", (1,), np.int64),
        ("ing_n_obs", (1,), np.int64),
        ("ing_n_steps", (1,), np.int64),
        ("ing_episode_reward", (1,), np.float64),
        ("ing_has_reward", (1,), np.int64),
    )


# slab-only scalar words of batch_slot_spec that the frame grammar
# already carries (header seq / frame CRC) or that are trainer-written
_SLAB_ONLY_FIELDS = frozenset(
    ("req_n", "req_seq", "req_crc", "rsp_seq", "rsp_crc"))


def net_sample_response_spec(cfg: Config, action_dim: int, batch: int):
    """The preassembled-batch response payload, derived from the shm
    sample slab spec by dropping the slab-only request/seq/CRC words —
    the row fields stay byte-identical to what the shm plane's slab
    carries, so the two transports assemble the same learner batch."""
    return tuple(e for e in batch_slot_spec(cfg, action_dim, batch)
                 if e[0] not in _SLAB_ONLY_FIELDS)


def net_feedback_spec(batch: int):
    """Priority-feedback payload: up to ``batch`` (idx, priority) rows
    plus the sample-time FIFO pointer the shard's stale mask keys on and
    the loss scalar the shard's stats accumulate."""
    return (("fb_idxes", (batch,), np.int64),
            ("fb_prios", (batch,), np.float64),
            ("fb_ptr", (1,), np.int64),
            ("fb_loss", (1,), np.float64))


def net_stats_spec(num_fields: int):
    """Mass/stat gossip payload: the stats-slab value vector (the shm
    plane's ``(seq, values, crc)`` slot with seq in the frame header and
    the CRC role taken by the frame CRC)."""
    return (("stats", (num_fields,), np.float64),)


def net_save_spec():
    """Drain-then-save control payload: snapshot path (length-prefixed
    bytes) + the routed-block / feedback expectations the shard must
    consume before writing (the shm plane's ctrl-queue tuple)."""
    return (("save_path", (SAVE_PATH_BYTES,), np.uint8),
            ("save_path_len", (1,), np.int64),
            ("save_blocks", (1,), np.int64),
            ("save_fb", (1,), np.int64))


def net_save_response_spec():
    """Save reply payload: the shard's snapshot meta as JSON bytes."""
    return (("meta_json", (SAVE_META_BYTES,), np.uint8),
            ("meta_len", (1,), np.int64))


def put_json(views: dict, field: str, len_field: str, obj) -> None:
    """Serialise ``obj`` into a bounded uint8 payload region."""
    raw = json.dumps(obj).encode()
    cap = views[field].shape[0]
    if len(raw) > cap:
        raise ValueError(
            f"{field}: {len(raw)} bytes exceeds the {cap}-byte region")
    views[field][:len(raw)] = np.frombuffer(raw, np.uint8)
    views[len_field][0] = len(raw)


def get_json(views: dict, field: str, len_field: str):
    """Inverse of :func:`put_json`."""
    n = int(views[len_field][0])
    return json.loads(bytes(views[field][:n]).decode())


def put_str(views: dict, field: str, len_field: str, s: str) -> None:
    raw = s.encode()
    cap = views[field].shape[0]
    if len(raw) > cap:
        raise ValueError(
            f"{field}: {len(raw)} bytes exceeds the {cap}-byte region")
    views[field][:len(raw)] = np.frombuffer(raw, np.uint8)
    views[len_field][0] = len(raw)


def get_str(views: dict, field: str, len_field: str) -> str:
    n = int(views[len_field][0])
    return bytes(views[field][:n]).decode()


def layout_token(cfg: Config, action_dim: int) -> int:
    """Geometry fingerprint of the derived frame layouts, exchanged in
    the HELLO handshake: a trainer and a shard built from drifted
    configs (different block geometry, batch size, leaf count) fail the
    attach instead of mis-framing every later message."""
    ing_n, _ = slot_layout(net_ingest_spec(cfg, action_dim))
    rsp_n, _ = slot_layout(
        net_sample_response_spec(cfg, action_dim, cfg.batch_size))
    return payload_crc32(
        (ing_n, rsp_n, cfg.batch_size, cfg.num_sequences, action_dim), [])


def max_net_frame_bytes(cfg: Config, action_dim: int) -> int:
    """The FrameReader desync bound for this geometry: the largest
    legitimate frame (ingest or sample response) plus header/CRC/framing
    slack — layout-derived so the bound stays tight at every scale."""
    ing_n, _ = slot_layout(net_ingest_spec(cfg, action_dim))
    rsp_n, _ = slot_layout(
        net_sample_response_spec(cfg, action_dim, cfg.batch_size))
    biggest = max(ing_n, rsp_n, SAVE_META_BYTES + SAVE_PATH_BYTES)
    return biggest + HEADER_WORDS * 8 + 64


def ingest_shape_header(views: dict) -> Tuple[int, int, int]:
    """The shm metadata-queue shape tuple of a decoded ingest frame."""
    return (int(views["ing_k"][0]), int(views["ing_n_obs"][0]),
            int(views["ing_n_steps"][0]))
