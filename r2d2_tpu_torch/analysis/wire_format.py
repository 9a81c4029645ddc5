"""wire-format: the slot layout and CRC conventions live in ONE module.

Five modules speak the shared-memory wire format (``replay/block.py``
defines it; ``parallel/actor_procs.py``,
``parallel/inference_service.py`` and ``parallel/replay_shards.py`` —
the sharded replay plane's block-routing and sample-RPC slabs —
transport over it), and the session tier (``serving/wire.py``) carries
the same conventions onto a local-socket transport for external
clients.  The CRC32 convention — int64 header words, payload arrays in
declared order, the 32-bit mask, written LAST — is a torn-write
detector only as long as the producer and verifier agree bit-for-bit;
a restated literal in one of the transport modules is exactly the kind
of drift that ships silently and corrupts recovery later.

The rule fires in any module that imports ``multiprocessing
.shared_memory`` or ``socket`` (the transport signatures) **other than
the wire-format modules themselves** when it:

- calls ``zlib.crc32`` directly (use ``replay.block.payload_crc32``),
- restates the 32-bit CRC mask literal ``0xFFFFFFFF``,
- re-defines a wire-format function (``slot_layout`` / ``slot_views`` /
  ``slot_crc`` / ``block_slot_spec`` / ``batch_slot_spec`` /
  ``write_block`` / ``read_block`` / ``payload_crc32``) instead of
  importing it,
- uses a wire-format name without importing it from
  ``r2d2_tpu_torch.replay.block``,
- and likewise for the session request/response vocabulary
  (``session_request_spec`` / ``session_response_spec`` /
  ``encode_frame`` / ``decode_frame`` / ``peek_kind`` /
  ``FrameReader``), whose canonical home is
  ``r2d2_tpu_torch.serving.wire`` (itself built ON the replay/block.py
  helpers — one CRC definition all the way down).
"""
from __future__ import annotations

import ast
from typing import List, Set

from r2d2_tpu_torch.analysis.core import Context, Finding, dotted_name, rule

RULE = "wire-format"

WIRE_MODULE = "r2d2_tpu_torch.replay.block"
WIRE_MODULE_SUFFIX = "replay/block.py"
WIRE_NAMES = {"slot_layout", "slot_views", "slot_crc", "block_slot_spec",
              "batch_slot_spec", "write_block", "read_block",
              "payload_crc32", "CRC_MASK", "BATCH_ROW_FIELDS"}
# the session tier's request/response vocabulary: defined once in
# serving/wire.py (on top of the replay/block.py CRC helpers), imported
# by every module that speaks the session protocol
SESSION_WIRE_MODULE = "r2d2_tpu_torch.serving.wire"
SESSION_WIRE_MODULE_SUFFIX = "serving/wire.py"
SESSION_WIRE_NAMES = {"session_request_spec", "session_response_spec",
                      "encode_frame", "decode_frame", "peek_kind",
                      "FrameReader"}
# the cross-host replay fabric's RPC vocabulary: the net frame specs and
# message kinds are canonical in replay/netwire.py (themselves DERIVED
# from replay/block.py's slot specs and framed by serving/wire.py's
# grammar — one CRC definition all the way down); a transport module
# restating a spec or a kind constant is exactly the drift that makes a
# shard and a trainer mis-frame each other's traffic
NET_WIRE_MODULE = "r2d2_tpu_torch.replay.netwire"
NET_WIRE_MODULE_SUFFIX = "replay/netwire.py"
NET_WIRE_NAMES = {"net_hello_spec", "net_ingest_spec",
                  "net_sample_response_spec", "net_feedback_spec",
                  "net_stats_spec", "net_save_spec",
                  "net_save_response_spec", "layout_token",
                  "max_net_frame_bytes", "ingest_shape_header",
                  "NMSG_HELLO", "NMSG_WELCOME", "NMSG_INGEST",
                  "NMSG_SAMPLE_REQ", "NMSG_SAMPLE_RSP", "NMSG_PRIO",
                  "NMSG_STATS", "NMSG_SAVE", "NMSG_SAVE_RSP"}
CRC_MASK_VALUE = 0xFFFFFFFF


def _uses_shared_memory(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.startswith("multiprocessing") for a in node.names):
                # `import multiprocessing as mp` alone isn't shm; require
                # the shared_memory submodule somewhere
                if any(a.name == "multiprocessing.shared_memory"
                       for a in node.names):
                    return True
        elif isinstance(node, ast.ImportFrom):
            if node.module == "multiprocessing" and any(
                    a.name == "shared_memory" for a in node.names):
                return True
            if node.module == "multiprocessing.shared_memory":
                return True
    return False


def _uses_socket(tree: ast.AST) -> bool:
    """The session tier's transport signature (serving/wire.py framing
    runs over plain ``socket``)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name == "socket" or a.name.startswith("socket.")
                   for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if node.module == "socket":
                return True
    return False


def _imports_from(tree: ast.AST, module: str) -> Set[str]:
    """Names imported from one canonical wire module."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == module:
            out.update(a.asname or a.name for a in node.names)
    return out


# (canonical module, its path suffix, its vocabulary) — the replay slab
# conventions, the session socket conventions and the cross-host replay
# RPC conventions, checked identically
_VOCABULARIES = (
    (WIRE_MODULE, WIRE_MODULE_SUFFIX, WIRE_NAMES),
    (SESSION_WIRE_MODULE, SESSION_WIRE_MODULE_SUFFIX, SESSION_WIRE_NAMES),
    (NET_WIRE_MODULE, NET_WIRE_MODULE_SUFFIX, NET_WIRE_NAMES),
)


@rule(RULE, "transport modules (shm or socket) import the slot layout / "
            "CRC / frame vocabulary from its canonical module instead of "
            "restating literals")
def check_wire_format(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for mod in ctx.modules:
        if not (_uses_shared_memory(mod.tree) or _uses_socket(mod.tree)):
            continue
        vocabularies = [
            (module, names, _imports_from(mod.tree, module))
            for module, suffix, names in _VOCABULARIES
            if not mod.rel.endswith(suffix)]
        is_wire_module = len(vocabularies) < len(_VOCABULARIES)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and not is_wire_module:
                d = dotted_name(node.func)
                if d in ("zlib.crc32", "crc32"):
                    findings.append(Finding(
                        RULE, mod.rel, node.lineno,
                        "direct zlib.crc32 in a transport module — "
                        "compute integrity words via "
                        "replay.block.payload_crc32 so producer and "
                        "verifier can never drift"))
            elif (isinstance(node, ast.Constant)
                  and type(node.value) is int
                  and node.value == CRC_MASK_VALUE
                  and not is_wire_module):
                findings.append(Finding(
                    RULE, mod.rel, node.lineno,
                    "restated CRC mask literal 0xFFFFFFFF — import the "
                    "convention from replay.block (payload_crc32/CRC_MASK)"))
            for module, names, imported in vocabularies:
                if (isinstance(node, (ast.FunctionDef, ast.ClassDef))
                        and node.name in names):
                    findings.append(Finding(
                        RULE, mod.rel, node.lineno,
                        f"wire-format {node.name!r} re-defined here — "
                        f"import it from {module}"))
                elif (isinstance(node, ast.Name)
                      and isinstance(node.ctx, ast.Store)
                      and node.id in names):
                    # a constant restated (e.g. a NMSG_* kind literal):
                    # the same drift as a re-defined function
                    findings.append(Finding(
                        RULE, mod.rel, node.lineno,
                        f"wire-format {node.id!r} re-defined here — "
                        f"import it from {module}"))
                elif (isinstance(node, ast.Name)
                      and isinstance(node.ctx, ast.Load)
                      and node.id in names
                      and node.id not in imported):
                    findings.append(Finding(
                        RULE, mod.rel, node.lineno,
                        f"wire-format name {node.id!r} used without "
                        f"importing it from {module}"))
    return findings
