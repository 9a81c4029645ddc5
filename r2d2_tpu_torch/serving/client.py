"""Client side of the session tier's wire protocol.

A :class:`SessionClient` (port of ``r2d2_tpu/serving/client.py``) is
what an external frontend embeds: one loopback TCP
connection multiplexing any number of episodic sessions, requests tagged
``(session_id, seq)`` so acts may be pipelined across sessions and
matched to replies out of order.  Every wait is bounded (a per-call
deadline; the server's own per-request deadline means a late reply was
already written off server-side too) and every frame is CRC-verified on
receipt — a garbled reply is dropped and surfaces as a timeout, never as
a consumed q-row of garbage.

One instance is single-threaded by design: give each worker thread its
own client, which also makes a worker's disconnect reap exactly that
worker's sessions server-side.
"""
from __future__ import annotations

import socket
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from r2d2_tpu_torch.config import Config
from r2d2_tpu_torch.serving.wire import (
    EMPTY_SPEC,
    FLAG_RESET,
    MSG_ACT,
    MSG_CLOSE,
    MSG_OPEN,
    MSG_RSP,
    FrameReader,
    WireClosed,
    WireGarbled,
    decode_frame,
    encode_frame,
    send_frame,
    session_request_spec,
    session_response_spec,
)
from r2d2_tpu_torch.utils.resilience import Deadline


class SessionClientError(Exception):
    """A client-side protocol failure (timeout / closed connection)."""


class SessionClient:
    """One connection to a :class:`~r2d2_tpu_torch.serving.server.
    SessionServer`, multiplexing many sessions (module docstring)."""

    def __init__(self, cfg: Config, action_dim: int, host: str, port: int,
                 timeout: float = 30.0):
        self.cfg = cfg
        self.action_dim = action_dim
        self.timeout = float(timeout)
        self.sock = socket.create_connection((host, port))
        # small request frames go out at once (no Nagle wait on the ACK)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.settimeout(0.05)
        self.reader = FrameReader(self.sock)
        self._wlock = threading.Lock()
        self._req_spec = session_request_spec(cfg, action_dim)
        self._rsp_spec = session_response_spec(cfg, action_dim)
        self._seq = 0
        # (sid, seq) -> (status, q or None): replies already pumped in
        self._inbox: Dict[Tuple[int, int], Tuple[int,
                                                 Optional[np.ndarray]]] = {}

    # ----------------------------------------------------------------- io
    def _send(self, frame: bytes) -> None:
        try:
            with self._wlock:
                send_frame(self.sock, frame)
        except OSError as e:
            raise SessionClientError(f"send failed: {e}")

    def _pump(self) -> None:
        """Drain every complete reply frame into the inbox (one bounded
        recv — the socket timeout is the poll step)."""
        try:
            frames = self.reader.poll()
        except WireClosed as e:
            raise SessionClientError(f"server closed the connection: {e}")
        for body in frames:
            # an OK act reply carries the q payload; every other reply is
            # payload-free — the body length picks the spec
            for spec in (self._rsp_spec, EMPTY_SPEC):
                try:
                    header, views = decode_frame(spec, body)
                except WireGarbled:
                    continue
                kind, sid, seq, status = header
                if kind == MSG_RSP:
                    q = (np.array(views["q"]) if "q" in views else None)
                    self._inbox[(sid, seq)] = (int(status), q)
                break
            # both specs failing CRC = a genuinely garbled reply: drop it
            # (the pending call times out, the server already moved on)

    def _await(self, sid: int, seq: int,
               timeout: Optional[float] = None
               ) -> Tuple[int, Optional[np.ndarray]]:
        deadline = Deadline(self.timeout if timeout is None else timeout)
        while True:
            hit = self._inbox.pop((sid, seq), None)
            if hit is not None:
                return hit
            if deadline.expired:
                raise SessionClientError(
                    f"no reply for session {sid} seq {seq} within "
                    f"{deadline.budget:.1f}s")
            self._pump()

    # ------------------------------------------------------------ protocol
    def next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def open_session(self, sid: int,
                     timeout: Optional[float] = None) -> int:
        seq = self.next_seq()
        self._send(encode_frame(EMPTY_SPEC, (MSG_OPEN, sid, seq, 0)))
        status, _ = self._await(sid, seq, timeout)
        return status

    def close_session(self, sid: int,
                      timeout: Optional[float] = None) -> int:
        seq = self.next_seq()
        self._send(encode_frame(EMPTY_SPEC, (MSG_CLOSE, sid, seq, 0)))
        status, _ = self._await(sid, seq, timeout)
        return status

    def send_act(self, sid: int, obs: np.ndarray, last_action: np.ndarray,
                 last_reward: float, reset: bool = False) -> int:
        """Fire one act request WITHOUT waiting (pipelining across
        sessions); returns the seq to :meth:`recv` on."""
        seq = self.next_seq()
        self._send(encode_frame(
            self._req_spec, (MSG_ACT, sid, seq,
                             FLAG_RESET if reset else 0),
            dict(obs=obs, last_action=last_action,
                 last_reward=np.asarray([last_reward], np.float32))))
        return seq

    def recv(self, sid: int, seq: int, timeout: Optional[float] = None
             ) -> Tuple[int, Optional[np.ndarray]]:
        """``(status, q or None)`` for a pipelined :meth:`send_act`."""
        return self._await(sid, seq, timeout)

    def poll_reply(self, sid: int, seq: int
                   ) -> Optional[Tuple[int, Optional[np.ndarray]]]:
        """Non-blocking :meth:`recv`: one bounded pump, then ``(status,
        q)`` if the reply is in, else None — the load generator's
        event-loop primitive (hundreds of sessions per worker thread
        without a thread per session)."""
        self._pump()
        return self._inbox.pop((sid, seq), None)

    def act(self, sid: int, obs: np.ndarray, last_action: np.ndarray,
            last_reward: float, reset: bool = False,
            timeout: Optional[float] = None
            ) -> Tuple[int, Optional[np.ndarray]]:
        """One synchronous act round-trip: ``(status, q or None)``."""
        seq = self.send_act(sid, obs, last_action, last_reward, reset)
        return self._await(sid, seq, timeout)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def abandon(self) -> None:
        """Drop the connection abruptly — the ``kill_session_client``
        chaos shape: no CLOSE for any live session; the server must reap
        them on the disconnect, never leak their hidden slots."""
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.close()
