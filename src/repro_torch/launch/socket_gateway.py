"""Real socket transport for the serving gateway (asyncio streams).

``launch/gateway.py`` gave the fleet an asyncio edge, but its
"connections" were in-process objects — the "millions of users" north
star had no wire.  This module binds :class:`OverlayGateway` to a real
transport: an :class:`OverlaySocketServer` speaking the length-prefixed
frame fabric of ``launch/transport.py`` over asyncio streams, and a
:class:`RemoteOverlayClient` any process can point at ``host:port``.

The protocol is REGISTER-ONCE, the wire analogue of the paper's
time-multiplexed context bank (and of just-in-time overlay assembly:
ship the program description once, then address it by key):

* ``register`` — the client serializes a kernel's DFG and its content
  key (``repro_torch.core.bank.context_key``: name + digest of the encoded
  instruction image).  The server compiles the DFG, *verifies the
  digest matches* (a corrupted or mismatched kernel is rejected, never
  silently served), and caches it in a server-wide registry.
* ``submit`` — every request after registration carries only the KEY,
  the input arrays, and a client request id.  No program bytes ride the
  hot path, exactly as no instruction fetch rides the overlay's
  steady-state datapath.

Everything the in-process edge guarantees carries over unchanged,
because every socket connection IS a ``GatewayConnection`` underneath:
per-connection admission, edge backpressure (a shed surfaces to the
client as :class:`GatewayOverloadedError` with the server's
``retry_after`` hint), session-keyed reconnect reclaim, and the
``flush_sync`` barrier (the ``flush`` frame runs the engine's
bit-for-bit barrier drain server-side).

Delivery is ACK-RETIRED so "zero ticket loss" survives a socket dying
mid-flight: the server holds every pushed result in a per-connection
unacked store until the client's ``ack`` frame retires it; results
still unacked when the connection drops are re-parked under the
session (``OverlayGateway.park_result``), so a reconnect reclaims them.
The boundary case — client received a result but its ack was lost —
re-delivers identical bytes on reclaim (at-least-once, never lost).

Telemetry rides the gateway's own sink under the ``wire.*`` namespace:
frames/bytes in/out, handshakes, registers, rejects, connections.

::

    # server process
    async with OverlaySocketServer.local(n_replicas=2, port=9178) as srv:
        await srv.serve_forever()

    # client process
    async with RemoteOverlayClient("127.0.0.1", 9178, tenant="alice",
                                   session="a-1") as client:
        t = await client.submit(kernel, [xs])      # registers once
        outs = await client.result(t)

A client of the JAX package and a server of this port (or the other way
round) talk to each other: the frames and messages are the same.
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import math

import numpy as np
import torch

from repro_torch.core.bank import context_key
from repro_torch.core.dfg import DFG, Node, Op
from repro_torch.core.overlay import compile_program
from repro_torch.core.vm import to_host
from repro_torch.launch.gateway import (GatewayClosedError, GatewayError,
                                  GatewayOverloadedError, OverlayGateway)
from repro_torch.launch.transport import (DEFAULT_MAX_FRAME_BYTES, CODECS,
                                    FrameTooLargeError, MalformedFrameError,
                                    PROTOCOL_VERSION, ProtocolVersionError,
                                    TransportError, read_frame, write_frame)
from repro_torch.sched.admission import AdmissionError

__all__ = [
    "OverlaySocketServer", "RemoteGatewayError", "RemoteOverlayClient",
    "dfg_from_wire", "dfg_to_wire",
]


class RemoteGatewayError(GatewayError):
    """A server-side failure with no more specific local exception."""


def _host_array(y) -> np.ndarray:
    """A result as the wire carries it: a numpy array on the host.  The
    streaming drains deliver numpy already; ``flush_sync`` delivers
    device tensors (a bfloat16 tensor widens to float32)."""
    return to_host(y) if isinstance(y, torch.Tensor) else np.asarray(y)


# --------------------------------------------------------- kernel handshake
def dfg_to_wire(dfg: DFG) -> dict:
    """Serialize a DFG for the register-once handshake (codec-neutral)."""
    return {
        "name": dfg.name,
        "inputs": list(dfg.inputs),
        "outputs": list(dfg.outputs),
        "nodes": [[n.name, int(n.op), list(n.args), n.imm]
                  for n in dfg.nodes.values()],
    }


def dfg_from_wire(spec: dict) -> DFG:
    """Rebuild (and re-validate) a DFG from its wire form."""
    nodes = [Node(name=name, op=Op(op), args=tuple(args), imm=imm)
             for name, op, args, imm in spec["nodes"]]
    return DFG.build(spec["name"], spec["inputs"], nodes, spec["outputs"])


def _error_to_exc(msg: dict) -> Exception:
    """Map a server ``error`` frame back onto the local exception type."""
    kind = msg.get("kind")
    text = msg.get("message", "")
    if kind == "overloaded":
        return GatewayOverloadedError(text,
                                      retry_after=msg.get("retry_after")
                                      or 0.0)
    if kind == "admission":
        return AdmissionError(msg.get("tenant", "?"),
                              msg.get("retry_after", math.inf))
    if kind == "closed":
        return GatewayClosedError(text)
    if kind == "version":
        return ProtocolVersionError(text)
    if kind == "unregistered":
        return KeyError(text)
    return RemoteGatewayError(f"{kind}: {text}")


class _SocketSession:
    """Server-side state of one accepted socket connection."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.wlock = asyncio.Lock()
        self.codec = "json"             # until the hello negotiates one
        self.conn = None                # the underlying GatewayConnection
        self.tasks: set[asyncio.Task] = set()
        #: results pushed but not yet acked: ticket -> outputs.  Whatever
        #: is still here when the socket dies is re-parked under the
        #: session so a reconnect reclaims it — delivery is only DONE
        #: when the client says so.
        self.unacked: dict[int, object] = {}

    def spawn(self, coro) -> None:
        t = asyncio.ensure_future(coro)
        self.tasks.add(t)
        t.add_done_callback(self.tasks.discard)


class OverlaySocketServer:
    """Asyncio-streams server binding an :class:`OverlayGateway` to TCP.

    ``gateway`` is wrapped, not owned: closing the server closes the
    listener and every accepted connection but leaves the gateway to its
    owner — unless the server built it via :meth:`local`.  ``port=0``
    binds an ephemeral port (read it back from :attr:`port` after
    :meth:`start`).
    """

    def __init__(self, gateway: OverlayGateway, host: str = "127.0.0.1",
                 port: int = 0, *,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        self.gateway = gateway
        self.host = host
        self._port = port
        self.max_frame_bytes = max_frame_bytes
        self.telemetry = gateway.telemetry
        #: register-once kernel registry, shared across ALL connections:
        #: context key -> CompiledKernel
        self._registry: dict[tuple, object] = {}
        self._server: asyncio.AbstractServer | None = None
        self._sessions: set[_SocketSession] = set()
        self._owns_gateway = False
        self._closed = False

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def local(cls, host: str = "127.0.0.1", port: int = 0, *,
              max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
              **gateway_kw) -> "OverlaySocketServer":
        """Build engine + pump + gateway + socket server in one call
        (`OverlayGateway.local` under the hood); the server owns the
        gateway and closes it on ``aclose``."""
        srv = cls(OverlayGateway.local(**gateway_kw), host, port,
                  max_frame_bytes=max_frame_bytes)
        srv._owns_gateway = True
        return srv

    async def start(self) -> "OverlaySocketServer":
        """Bind and start accepting (idempotent)."""
        if self._server is not None:
            return self
        if self._closed:
            raise GatewayClosedError("socket server is closed")
        self.gateway._require_loop()
        self._server = await asyncio.start_server(
            self._handle, self.host, self._port)
        self._port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def port(self) -> int:
        """The bound port (the ephemeral one when built with ``port=0``)."""
        return self._port

    async def serve_forever(self) -> None:
        await self.start()
        await self._server.serve_forever()

    async def aclose(self) -> None:
        """Stop accepting, tear down live connections (their undelivered
        work parks under their sessions), and close the gateway if this
        server built it.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        handlers = [t for s in list(self._sessions) for t in (s.tasks or ())]
        for s in list(self._sessions):
            try:
                s.writer.close()
            except Exception:
                pass
        # handler coroutines notice EOF and unwind themselves; give their
        # per-submit tasks a chance to re-park before yanking them
        for t in handlers:
            t.cancel()
        if handlers:
            await asyncio.gather(*handlers, return_exceptions=True)
        while self._sessions:
            await asyncio.sleep(0.001)
        if self._owns_gateway:
            await self.gateway.aclose()

    async def __aenter__(self) -> "OverlaySocketServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    # -------------------------------------------------------------- metrics
    def stats(self) -> dict:
        """Wire-level counters + the wrapped gateway's stats dict."""
        tel = self.telemetry
        return {
            "listening": self._server is not None and not self._closed,
            "open_connections": len(self._sessions),
            "registered_kernels": len(self._registry),
            "wire_frames_in": int(tel.counter("wire.frames_in")),
            "wire_frames_out": int(tel.counter("wire.frames_out")),
            "wire_bytes_in": int(tel.counter("wire.bytes_in")),
            "wire_bytes_out": int(tel.counter("wire.bytes_out")),
            "wire_handshakes": int(tel.counter("wire.handshakes")),
            "wire_registers": int(tel.counter("wire.registers")),
            "wire_rejects": int(tel.counter("wire.rejects")),
            "wire_connections": int(tel.counter("wire.connections")),
            "wire_disconnects": int(tel.counter("wire.disconnects")),
            "wire_reparked": int(tel.counter("wire.reparked")),
            "gateway": self.gateway.stats(),
        }

    # ------------------------------------------------------------- handler
    async def _send(self, sess: _SocketSession, msg: dict,
                    codec: str | None = None) -> None:
        async with sess.wlock:
            n = await write_frame(sess.writer, msg, codec or sess.codec,
                                  self.max_frame_bytes)
        self.telemetry.inc("wire.frames_out")
        self.telemetry.inc("wire.bytes_out", n)

    def _count_in(self, n: int) -> None:
        self.telemetry.inc("wire.frames_in")
        self.telemetry.inc("wire.bytes_in", n)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        tel = self.telemetry
        tel.inc("wire.connections")
        sess = _SocketSession(writer)
        self._sessions.add(sess)
        try:
            if await self._handshake(sess, reader):
                await self._read_loop(sess, reader)
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            if sess.conn is not None:
                # close the connection FIRST — its body is await-free, so
                # parking is atomic within this loop turn.  Cancelling the
                # serve tasks first would cancel their result futures and
                # then yield (gather), letting a pump tick claim a
                # delivered result into a cancelled future and drop it.
                await sess.conn.close()
            for t in list(sess.tasks):
                t.cancel()
            if sess.tasks:
                await asyncio.gather(*sess.tasks, return_exceptions=True)
            if sess.conn is not None:
                # everything pushed but never acked goes back to the
                # session's orphan store: the client may never have seen it
                for ticket, ys in sess.unacked.items():
                    self.gateway.park_result(sess.conn.session, ticket, ys)
                    tel.inc("wire.reparked")
                sess.unacked.clear()
            tel.inc("wire.disconnects")
            self._sessions.discard(sess)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _handshake(self, sess: _SocketSession,
                         reader: asyncio.StreamReader) -> bool:
        """Consume the hello frame; reply welcome (or a refusal).
        Returns True when the connection may proceed to the read loop."""
        tel = self.telemetry
        try:
            hello = await read_frame(reader, self.max_frame_bytes,
                                     on_bytes=self._count_in)
        except ProtocolVersionError as e:
            tel.inc("wire.rejects")
            await self._send(sess, {"type": "error", "kind": "version",
                                    "message": str(e)}, "json")
            return False
        except (MalformedFrameError, FrameTooLargeError) as e:
            tel.inc("wire.rejects")
            await self._send(sess, {"type": "error", "kind": "malformed",
                                    "message": str(e)}, "json")
            return False
        if hello is None:
            return False
        if not isinstance(hello, dict) or hello.get("type") != "hello":
            tel.inc("wire.rejects")
            await self._send(sess, {"type": "error", "kind": "protocol",
                                    "message": "expected a hello frame"},
                             "json")
            return False
        if hello.get("proto") != PROTOCOL_VERSION:
            tel.inc("wire.rejects")
            await self._send(sess, {
                "type": "error", "kind": "version",
                "message": (f"server speaks protocol v{PROTOCOL_VERSION}; "
                            f"client sent v{hello.get('proto')}")}, "json")
            return False
        offered = hello.get("codecs") or ["json"]
        sess.codec = next((c for c in CODECS if c in offered), "json")
        try:
            sess.conn = self.gateway.connect(
                tenant=hello.get("tenant") or "default",
                session=hello.get("session"))
        except GatewayClosedError as e:
            await self._send(sess, {"type": "error", "kind": "closed",
                                    "message": str(e)}, "json")
            return False
        tel.inc("wire.handshakes")
        await self._send(sess, {
            "type": "welcome", "proto": PROTOCOL_VERSION,
            "codec": sess.codec, "session": sess.conn.session,
            "tile": getattr(self.gateway.server, "tile", 128)}, "json")
        return True

    async def _read_loop(self, sess: _SocketSession,
                         reader: asyncio.StreamReader) -> None:
        tel = self.telemetry
        while True:
            try:
                msg = await read_frame(reader, self.max_frame_bytes,
                                       on_bytes=self._count_in)
            except (MalformedFrameError, FrameTooLargeError,
                    ProtocolVersionError) as e:
                tel.inc("wire.rejects")
                try:
                    await self._send(sess, {"type": "error",
                                            "kind": "malformed",
                                            "message": str(e)})
                except Exception:
                    pass
                return
            if msg is None or not isinstance(msg, dict) \
                    or msg.get("type") == "bye":
                return
            mtype = msg.get("type")
            if mtype == "register":
                await self._serve_register(sess, msg)
            elif mtype == "submit":
                sess.spawn(self._serve_submit(sess, msg))
            elif mtype == "flush":
                sess.spawn(self._serve_flush(sess, msg))
            elif mtype == "reclaim":
                sess.spawn(self._serve_reclaim(sess, msg))
            elif mtype == "ack":
                for t in msg.get("tickets") or ():
                    sess.unacked.pop(t, None)
            else:
                tel.inc("wire.rejects")
                await self._send(sess, {
                    "type": "error", "kind": "protocol",
                    "req": msg.get("req"),
                    "message": f"unknown frame type {mtype!r}"})

    # --------------------------------------------------------- frame serving
    async def _serve_register(self, sess: _SocketSession, msg: dict) -> None:
        req = msg.get("req")
        key = tuple(msg.get("key") or ())
        if key in self._registry:       # register-once: later ones are acks
            await self._send(sess, {"type": "registered", "req": req,
                                    "key": list(key)})
            return
        try:
            kernel = compile_program(dfg_from_wire(msg["dfg"]))
        except Exception as e:
            self.telemetry.inc("wire.rejects")
            await self._send(sess, {"type": "error", "kind": "bad_kernel",
                                    "req": req, "message": repr(e)})
            return
        actual = context_key(kernel)
        if tuple(actual) != key:
            # the client's claimed identity does not match what its DFG
            # compiles to — refuse rather than serve a kernel under a key
            # some other client may later collide with
            self.telemetry.inc("wire.rejects")
            await self._send(sess, {
                "type": "error", "kind": "key_mismatch", "req": req,
                "message": (f"claimed context key {key!r} but the DFG "
                            f"compiles to {tuple(actual)!r}")})
            return
        self._registry[key] = kernel
        self.telemetry.inc("wire.registers")
        self.telemetry.event("wire_register", key=list(key),
                             tenant=sess.conn.tenant)
        await self._send(sess, {"type": "registered", "req": req,
                                "key": list(key)})

    async def _serve_submit(self, sess: _SocketSession, msg: dict) -> None:
        conn, req = sess.conn, msg.get("req")
        kernel = self._registry.get(tuple(msg.get("key") or ()))
        if kernel is None:
            self.telemetry.inc("wire.rejects")
            await self._send(sess, {
                "type": "error", "kind": "unregistered", "req": req,
                "message": (f"kernel key {msg.get('key')!r} was never "
                            f"registered on this server")})
            return
        xs = [np.asarray(x) for x in msg.get("xs") or []]
        try:
            ticket = await conn.submit(kernel, xs)
        except GatewayOverloadedError as e:
            await self._send(sess, {"type": "error", "kind": "overloaded",
                                    "req": req, "message": str(e),
                                    "retry_after": e.retry_after})
            return
        except AdmissionError as e:
            await self._send(sess, {"type": "error", "kind": "admission",
                                    "req": req, "message": str(e),
                                    "tenant": e.tenant,
                                    "retry_after": e.retry_after})
            return
        except GatewayClosedError as e:
            await self._send(sess, {"type": "error", "kind": "closed",
                                    "req": req, "message": str(e)})
            return
        except asyncio.CancelledError:
            raise
        except Exception as e:
            await self._send(sess, {"type": "error", "kind": "internal",
                                    "req": req, "message": repr(e)})
            return
        await self._send(sess, {"type": "ticket", "req": req,
                                "ticket": ticket})
        try:
            ys = await conn.result(ticket)
        except (asyncio.CancelledError, GatewayClosedError):
            return      # teardown: conn.close() parks the ticket
        except KeyError as e:
            await self._send(sess, {"type": "error", "kind": "claimed",
                                    "req": req, "ticket": ticket,
                                    "message": str(e)})
            return
        ys = [_host_array(y) for y in ys]
        sess.unacked[ticket] = ys       # before the write: no ack can race
        try:
            await self._send(sess, {"type": "result", "ticket": ticket,
                                    "ys": ys})
        except asyncio.CancelledError:
            raise                       # teardown re-parks via unacked
        except (ConnectionError, RuntimeError):
            pass                        # ditto: still in unacked

    async def _serve_flush(self, sess: _SocketSession, msg: dict) -> None:
        try:
            results = await self.gateway.flush_sync()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            await self._send(sess, {"type": "error", "kind": "internal",
                                    "req": msg.get("req"),
                                    "message": repr(e)})
            return
        await self._send(sess, {"type": "flushed", "req": msg.get("req"),
                                "n": len(results)})

    async def _serve_reclaim(self, sess: _SocketSession, msg: dict) -> None:
        try:
            out = await sess.conn.reclaim()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            await self._send(sess, {"type": "error", "kind": "internal",
                                    "req": msg.get("req"),
                                    "message": repr(e)})
            return
        pairs = [[t, [_host_array(y) for y in ys]]
                 for t, ys in sorted(out.items())]
        # reclaim is claim-once gateway-side, so the values ride the
        # unacked store too: if this frame never lands, teardown re-parks
        for t, ys in pairs:
            sess.unacked[t] = ys
        await self._send(sess, {"type": "reclaimed", "req": msg.get("req"),
                                "results": pairs})


class RemoteOverlayClient:
    """Client end of the socket gateway: the `GatewayConnection` surface
    (``submit`` / ``result`` / ``results`` / ``drain`` / ``flush_sync`` /
    ``reclaim``) over one TCP connection.

    Kernels are registered once per (client, kernel) — ``submit`` sends
    the DFG on first use of a kernel and only its content key after.
    ``session`` names the reconnectable identity exactly like the
    in-process gateway: a client that dies with results in flight can be
    replaced by a new client with the same session id, and ``reclaim()``
    returns everything the server held for it.
    """

    def __init__(self, host: str, port: int, *, tenant: str = "default",
                 session: str | None = None,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        self.host = host
        self.port = port
        self.tenant = tenant
        self.session = session
        self.max_frame_bytes = max_frame_bytes
        self.codec: str | None = None       # negotiated at connect
        self.tile = 128
        self.closed = False
        self.counters: collections.Counter = collections.Counter()
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._reader_task: asyncio.Task | None = None
        self._wlock = asyncio.Lock()
        self._req_seq = itertools.count()
        #: req id -> future (register/submit/flush/reclaim acks)
        self._reqs: dict[int, asyncio.Future] = {}
        #: ticket -> future resolving to its outputs
        self._results: dict[int, asyncio.Future] = {}
        #: context key -> future completing when registration is acked
        self._registered: dict[tuple, asyncio.Future] = {}

    # ------------------------------------------------------------ lifecycle
    async def connect(self) -> "RemoteOverlayClient":
        """Open the socket and run the hello/welcome handshake."""
        if self._writer is not None or self.closed:
            raise GatewayError("client already connected or closed")
        reader, writer = await asyncio.open_connection(self.host, self.port)
        self._reader, self._writer = reader, writer
        n = await write_frame(writer, {
            "type": "hello", "proto": PROTOCOL_VERSION,
            "tenant": self.tenant, "session": self.session,
            "codecs": list(CODECS)}, "json", self.max_frame_bytes)
        self._count("out", n)
        resp = await read_frame(reader, self.max_frame_bytes,
                                on_bytes=lambda n: self._count("in", n))
        if resp is None:
            raise TransportError("server closed during the handshake")
        if resp.get("type") == "error":
            raise _error_to_exc(resp)
        if resp.get("type") != "welcome":
            raise MalformedFrameError(
                f"expected a welcome frame, got {resp.get('type')!r}")
        self.codec = resp["codec"]
        self.tile = resp.get("tile", 128)
        self._reader_task = asyncio.get_running_loop().create_task(
            self._read_loop())
        return self

    async def aclose(self) -> None:
        """Close the connection (idempotent).  Results still in flight are
        re-parked server-side under this client's session."""
        if self.closed:
            return
        self.closed = True
        if self._writer is not None:
            try:
                await self._send({"type": "bye"})
            except Exception:
                pass
        if self._reader_task is not None:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except (asyncio.CancelledError, Exception):
                pass
        self._fail_pending(GatewayClosedError("client closed"))
        if self._writer is not None:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except Exception:
                pass

    async def __aenter__(self) -> "RemoteOverlayClient":
        return await self.connect()

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    # -------------------------------------------------------------- plumbing
    def _count(self, direction: str, n: int) -> None:
        self.counters[f"frames_{direction}"] += 1
        self.counters[f"bytes_{direction}"] += n

    def _check_open(self) -> None:
        if self.closed or self._writer is None:
            raise GatewayClosedError(
                f"client (tenant={self.tenant!r}, session={self.session!r})"
                f" is not connected")

    async def _send(self, msg: dict) -> None:
        async with self._wlock:
            n = await write_frame(self._writer, msg, self.codec,
                                  self.max_frame_bytes)
        self._count("out", n)

    def _new_req(self) -> tuple[int, asyncio.Future]:
        req = next(self._req_seq)
        fut = asyncio.get_running_loop().create_future()
        self._reqs[req] = fut
        return req, fut

    async def _read_loop(self) -> None:
        exc: Exception | None = None
        try:
            while True:
                msg = await read_frame(
                    self._reader, self.max_frame_bytes,
                    on_bytes=lambda n: self._count("in", n))
                if msg is None:
                    break
                await self._dispatch(msg)
        except asyncio.CancelledError:
            return
        except (TransportError, ConnectionError) as e:
            exc = e
        finally:
            self._fail_pending(exc or GatewayClosedError(
                "server closed the connection"))

    async def _dispatch(self, msg: dict) -> None:
        mtype = msg.get("type")
        if mtype == "ticket":
            ticket = msg["ticket"]
            loop = asyncio.get_running_loop()
            self._results.setdefault(ticket, loop.create_future())
            fut = self._reqs.pop(msg.get("req"), None)
            if fut is not None and not fut.done():
                fut.set_result(ticket)
        elif mtype == "result":
            # NOT acked here: the ack means "the caller CLAIMED it", so
            # results a dropping client received but never awaited stay
            # unacked server-side and re-park for reclaim — the wire
            # analogue of close() parking done-but-unawaited futures
            ticket = msg["ticket"]
            ys = [np.asarray(y) for y in msg.get("ys") or []]
            fut = self._results.get(ticket)
            if fut is not None and not fut.done():
                fut.set_result(ys)
                self.counters["delivered"] += 1
        elif mtype in ("registered", "flushed", "reclaimed"):
            fut = self._reqs.pop(msg.get("req"), None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
        elif mtype == "error":
            exc = _error_to_exc(msg)
            req, ticket = msg.get("req"), msg.get("ticket")
            fut = self._reqs.pop(req, None) if req is not None else None
            if fut is None and ticket is not None:
                fut = self._results.pop(ticket, None)
            if fut is not None and not fut.done():
                fut.set_exception(exc)
            # a connection-level refusal (no req/ticket) fails everything
            elif fut is None:
                self._fail_pending(exc)

    def _fail_pending(self, exc: Exception) -> None:
        for fut in list(self._reqs.values()) + list(self._results.values()):
            if not fut.done():
                fut.set_exception(exc)
                fut.exception()         # mark retrieved: awaiters still see it
        self._reqs.clear()
        for key, fut in list(self._registered.items()):
            if not fut.done():
                fut.set_exception(exc)
                fut.exception()

    async def _ack(self, tickets) -> None:
        """Retire claimed tickets server-side (best effort: a closed
        connection just leaves them unacked, i.e. reclaimable)."""
        tickets = list(tickets)
        if not tickets or self.closed or self._writer is None:
            return
        try:
            await self._send({"type": "ack", "tickets": tickets})
        except (ConnectionError, RuntimeError):
            pass

    # ---------------------------------------------------------------- client
    async def _ensure_registered(self, kernel) -> tuple:
        key = context_key(kernel)
        fut = self._registered.get(key)
        if fut is not None:
            await asyncio.shield(fut)
            return key
        loop = asyncio.get_running_loop()
        fut = self._registered[key] = loop.create_future()
        req, ack = self._new_req()
        try:
            await self._send({"type": "register", "req": req,
                              "key": list(key),
                              "dfg": dfg_to_wire(kernel.dfg)})
            await ack
        except Exception as e:
            self._registered.pop(key, None)
            if not fut.done():
                fut.set_exception(e)
                fut.exception()
            raise
        self.counters["registered"] += 1
        if not fut.done():
            fut.set_result(True)
        return key

    async def submit(self, kernel, xs) -> int:
        """Register-once + submit; returns the fleet's global ticket.

        Server-side admission and backpressure surface as the SAME
        exceptions the in-process gateway raises (``AdmissionError``,
        ``GatewayOverloadedError`` with ``retry_after``, ...).
        """
        self._check_open()
        key = await self._ensure_registered(kernel)
        req, fut = self._new_req()
        await self._send({"type": "submit", "req": req, "key": list(key),
                          "xs": [np.asarray(x) for x in xs]})
        ticket = await fut
        self.counters["submitted"] += 1
        return ticket

    async def result(self, ticket: int):
        """Await one ticket's outputs (claim-once, like the engine)."""
        self._check_open()
        fut = self._results.get(ticket)
        if fut is None:
            raise KeyError(f"ticket {ticket} is not outstanding on this "
                           f"client")
        try:
            ys = await fut
        finally:
            if fut.done() and not fut.cancelled():
                self._results.pop(ticket, None)
        await self._ack([ticket])
        return ys

    async def results(self):
        """``async for ticket, outs`` in completion order, streaming."""
        while self._results:
            self._check_open()
            done = [t for t, f in self._results.items() if f.done()]
            if not done:
                await asyncio.wait(list(self._results.values()),
                                   return_when=asyncio.FIRST_COMPLETED)
                continue
            for t in done:
                fut = self._results.pop(t)
                await self._ack([t])
                yield t, fut.result()

    async def drain(self) -> dict:
        """Await everything outstanding on this client."""
        out = {}
        async for t, ys in self.results():
            out[t] = ys
        return out

    async def flush_sync(self) -> dict:
        """Run the engine's barrier drain server-side, then claim every
        ticket outstanding on THIS client; returns ``{ticket: outputs}``."""
        self._check_open()
        req, fut = self._new_req()
        await self._send({"type": "flush", "req": req})
        await fut                       # barrier completed server-side
        out = {}
        for t in list(self._results):
            out[t] = await self.result(t)
        return out

    async def reclaim(self) -> dict:
        """Claim results parked under this client's session by a previous
        (dropped) connection — exactly once server-side."""
        self._check_open()
        req, fut = self._new_req()
        await self._send({"type": "reclaim", "req": req})
        msg = await fut
        out = {int(t): [np.asarray(y) for y in ys]
               for t, ys in msg.get("results") or []}
        await self._ack(out)            # returned to the caller = claimed
        self.counters["reclaimed"] += len(out)
        return out

    @property
    def outstanding(self) -> frozenset[int]:
        """Tickets submitted on this client and not yet claimed."""
        return frozenset(self._results)

    def stats(self) -> dict:
        return {"codec": self.codec, "closed": self.closed,
                "outstanding": len(self._results),
                **{k: int(v) for k, v in sorted(self.counters.items())}}
