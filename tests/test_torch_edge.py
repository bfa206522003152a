"""The network edge of the port — frame codec, asyncio gateway, socket
server and client — against the JAX package's.

* FRAMES: ``encode_frame`` of both packages gives the same bytes for the
  same message, in both codecs, and each package decodes the other's.
  Rejections raise errors of the same names.
* GATEWAY: submit/await through the port's ``OverlayGateway`` (over the
  port's fleet on the CPU) delivers, bit for bit, what the JAX fleet's
  ``flush_sync`` delivers for the same trace; so do the streaming
  ``results()``, the gateway's ``flush_sync`` and a reconnect's
  ``reclaim``.
* WIRE: over loopback, a JAX ``RemoteOverlayClient`` talks to the port's
  ``OverlaySocketServer`` and the port's client to the JAX server, in
  both codecs; results equal the JAX fleet's bit for bit.
* The one known difference: a bfloat16 overlay of the port delivers
  float32 (numpy has no bfloat16), so its frames name ``float32`` where
  the reference's name ``bfloat16``.  The values are equal.

Every await carries its own timeout (``WAIT_S``) and fails when it runs
out; no async pytest plugin.
"""

import asyncio

import numpy as np
import pytest
import torch

from repro.core import bank as jbank
from repro.core import overlay as joverlay
from repro.core import paper_bench as jbench
from repro.launch import gateway as jgate
from repro.launch import serve as jserve
from repro.launch import socket_gateway as jsock
from repro.launch import transport as jtrans
from repro_torch.core import bank as tbank
from repro_torch.core import overlay as toverlay
from repro_torch.core import paper_bench as tbench
from repro_torch.launch import gateway as tgate
from repro_torch.launch import serve as tserve
from repro_torch.launch import socket_gateway as tsock
from repro_torch.launch import transport as ttrans
from repro_torch.telemetry import check_stats
from torch_port_support import assert_same_bits

torch.set_num_threads(1)

NAMES = tuple(jbench.BENCH_NAMES) + ("gradient",)
CPU = torch.device("cpu")
CODECS = ("json", "msgpack")
#: every asyncio wait, socket read and pump wait in this file
WAIT_S = 60.0


def run(coro):
    """``asyncio.run`` with one overall timeout on top of the per-await
    ones: a hang fails the test instead of stalling the run."""
    return asyncio.run(asyncio.wait_for(coro, 4 * WAIT_S))


def wait(aw):
    return asyncio.wait_for(aw, WAIT_S)


@pytest.fixture(scope="module")
def kernels():
    return {n: (joverlay.compile_program(jbench.benchmark(n)),
                toverlay.compile_program(tbench.benchmark(n)))
            for n in NAMES}


def _trace(n, seed, lanes=(128, 256)):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        name = NAMES[rng.randint(len(NAMES))]
        b = int(rng.choice(lanes))
        out.append((name, [rng.uniform(-2, 2, (b,)).astype(np.float32)
                           for _ in jbench.benchmark(name).inputs]))
    return out


def _jax_oracle(kernels, trace, **kw):
    """What the JAX fleet's barrier drain delivers for ``trace``, in
    trace order."""
    import jax
    n = kw.pop("n_replicas", 2)
    srv = jserve.ShardedOverlayServer(n_replicas=n, backend="jnp",
                                      devices=[jax.devices()[0]] * n, **kw)
    tickets = [srv.submit(kernels[name][0], xs) for name, xs in trace]
    out = srv.flush_sync()
    return [out[t] for t in tickets]


def _same(got, want, what):
    assert len(got) == len(want), what
    for y, w in zip(got, want):
        assert_same_bits(np.asarray(y), np.asarray(w), what)


def _port_fleet(n=2, **kw):
    return tserve.ShardedOverlayServer(n_replicas=n, devices=[CPU] * n,
                                       bank_capacity=4, **kw)


# ================================================================= frames
def _messages():
    rng = np.random.RandomState(0)
    return [
        {"type": "hello", "proto": 1, "tenant": "a", "session": None,
         "codecs": ["msgpack", "json"]},
        {"type": "submit", "req": 7, "key": ["poly5", "ab" * 20],
         "xs": [rng.uniform(-2, 2, 300).astype(np.float32),
                rng.uniform(-2, 2, 300).astype(np.float32)]},
        {"type": "result", "ticket": 3,
         "ys": [np.array([np.nan, -0.0, np.inf, 1e-40], np.float32),
                np.arange(-5, 5, dtype=np.int32),
                rng.uniform(size=(3, 4)).astype(np.float64)]},
        {"type": "reclaimed", "req": 1,
         "results": [[0, [np.zeros(0, np.float32)]],
                     [4, [np.ones(7, np.uint8)]]]},
        {"type": "error", "kind": "overloaded", "message": "full",
         "retry_after": 0.002, "meta": {"nested": [1, 2.5, "s", None, True],
                                        "empty": []}},
        {"type": "registered", "req": 2, "key": ["x", "0" * 40],
         "n": np.int64(5), "f": np.float32(0.25)},
    ]


def _same_message(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same_message(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for u, v in zip(a, b):
            _same_message(u, v)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("which", range(6))
def test_frames_are_the_reference_bytes(codec, which):
    if codec == "msgpack":
        pytest.importorskip("msgpack")
    msg = _messages()[which]
    tb, jb = ttrans.encode_frame(msg, codec), jtrans.encode_frame(msg, codec)
    assert tb == jb
    assert tb[:2] == b"\xf5\x9e" and len(tb) - ttrans.HEADER_BYTES == \
        int.from_bytes(tb[4:8], "big")
    # each decodes the other's, and reports the same frame length
    t_of_j, n1 = ttrans.decode_frame(jb)
    j_of_t, n2 = jtrans.decode_frame(tb)
    assert n1 == n2 == len(tb)
    _same_message(t_of_j, j_of_t)


def test_codec_surface_matches_the_reference():
    for name in ("PROTOCOL_VERSION", "MAGIC", "HEADER_BYTES",
                 "DEFAULT_MAX_FRAME_BYTES", "CODECS", "HAVE_MSGPACK"):
        assert getattr(ttrans, name) == getattr(jtrans, name), name
    assert set(ttrans.__all__) == set(jtrans.__all__)
    assert ttrans.default_codec() == jtrans.default_codec()


def _rejection(mod, buf, **kw):
    try:
        mod.decode_frame(buf, **kw)
    except mod.TransportError as e:
        return type(e).__name__
    return None


@pytest.mark.parametrize("case", ("truncated_header", "truncated_payload",
                                  "bad_magic", "version", "codec_id",
                                  "too_large", "garbage_json"))
def test_rejections_match_the_reference(case):
    good = jtrans.encode_frame({"type": "x", "v": [1, 2]}, "json")
    buf, kw = good, {}
    if case == "truncated_header":
        buf = good[:5]
    elif case == "truncated_payload":
        buf = good[:-1]
    elif case == "bad_magic":
        buf = b"\x00\x00" + good[2:]
    elif case == "version":
        buf = good[:2] + bytes([jtrans.PROTOCOL_VERSION + 1]) + good[3:]
    elif case == "codec_id":
        buf = good[:3] + b"\x07" + good[4:]
    elif case == "too_large":
        kw = {"max_bytes": 4}
    else:
        body = b"{not json"
        buf = good[:4] + len(body).to_bytes(4, "big") + body
    want = _rejection(jtrans, buf, **kw)
    assert want is not None
    assert _rejection(ttrans, buf, **kw) == want
    with pytest.raises(ttrans.FrameTooLargeError):
        ttrans.encode_frame({"b": "x" * 64}, "json", max_bytes=8)


def test_stream_frames_cross_read():
    """``write_frame`` of one package, ``read_frame`` of the other, over
    an asyncio stream, with the byte count hook."""
    async def main():
        seen = []
        reader = asyncio.StreamReader()
        for mod in (ttrans, jtrans):
            reader.feed_data(mod.encode_frame(_messages()[2], "json"))
        reader.feed_eof()
        a = await wait(jtrans.read_frame(reader, on_bytes=seen.append))
        b = await wait(ttrans.read_frame(reader, on_bytes=seen.append))
        assert await wait(ttrans.read_frame(reader)) is None
        _same_message(a, b)
        assert seen[0] == seen[1] == len(ttrans.encode_frame(
            _messages()[2], "json"))
    run(main())


# ================================================================ gateway
def test_gateway_submit_await_matches_the_jax_fleet(kernels):
    """Per-ticket awaits, then a reconnect's reclaim and the gateway's
    ``flush_sync``, all against the JAX fleet's barrier drain."""
    trace = _trace(18, seed=1)
    want = _jax_oracle(kernels, trace)

    async def main():
        gw = tgate.OverlayGateway(_port_fleet(), poll_interval=0.001)
        async with gw:
            got = {}
            async with gw.connect(tenant="alice", session="s1") as conn:
                tickets = [await wait(conn.submit(kernels[n][1], xs))
                           for n, xs in trace[:8]]
                for i, t in enumerate(tickets):
                    got[i] = await wait(conn.result(t))
                # streaming: results picked up as they land
                more = [await wait(conn.submit(kernels[n][1], xs))
                        for n, xs in trace[8:12]]
                stream = {}
                async for t, outs in conn.results():
                    stream[t] = outs
                    if len(stream) == len(more):
                        break
                for i, t in enumerate(more):
                    got[8 + i] = stream[t]
                # dropped with work in flight: parked under the session
                late = [await wait(conn.submit(kernels[n][1], xs))
                        for n, xs in trace[12:15]]
            async with gw.connect(tenant="alice", session="s1") as conn:
                back = await wait(conn.reclaim())
                for i, t in enumerate(late):
                    got[12 + i] = back[t]
                tail = [await wait(conn.submit(kernels[n][1], xs))
                        for n, xs in trace[15:]]
                flushed = await wait(gw.flush_sync())
                for i, t in enumerate(tail):
                    got[15 + i] = flushed[t]
            st = gw.stats()
            check_stats("gateway", st)
            assert st["edge_submitted"] == len(trace)
            return got

    got = run(main())
    assert sorted(got) == list(range(len(trace)))
    for i in range(len(trace)):
        _same(got[i], want[i], f"request {i}")


def test_gateway_sheds_and_closes_as_the_reference(kernels):
    name, xs = _trace(1, seed=2, lanes=(256,))[0]

    async def shed(mod, srv, k):
        async with mod.OverlayGateway(srv, max_fleet_tiles=2,
                                      overflow="shed",
                                      poll_interval=0.001) as gw:
            conn = gw.connect()
            await wait(conn.submit(k, xs))            # 2 tiles: at the bound
            with pytest.raises(mod.GatewayOverloadedError) as e:
                await wait(conn.submit(k, xs))
            assert e.value.retry_after > 0
            n_shed = gw.n_shed
        with pytest.raises(mod.GatewayClosedError):
            gw.connect()
        return n_shed

    import jax
    j = run(shed(jgate, jserve.ShardedOverlayServer(
        n_replicas=2, backend="jnp", devices=[jax.devices()[0]] * 2),
        kernels[name][0]))
    t = run(shed(tgate, _port_fleet(), kernels[name][1]))
    assert t == j == 1
    assert set(tgate.__all__) == set(jgate.__all__)


# =================================================================== wire
def _server(mod, fleet_kw=None):
    """A socket server of either package over a 2-replica fleet of that
    package on the CPU."""
    kw = dict(n_replicas=2, bank_capacity=4, poll_interval=0.001)
    if mod is tsock:
        kw["server_kw"] = {"devices": [CPU] * 2, **(fleet_kw or {})}
    else:
        import jax
        kw["server_kw"] = {"backend": "jnp",
                           "devices": [jax.devices()[0]] * 2,
                           **(fleet_kw or {})}
    return mod.OverlaySocketServer.local(**kw)


async def _drive(client_mod, port, kernels, trace, which):
    """Submit the trace through a client of ``client_mod``; the first
    half is awaited per ticket, the second streamed."""
    got = {}
    async with client_mod.RemoteOverlayClient("127.0.0.1", port,
                                              tenant="t",
                                              session="x") as c:
        half = len(trace) // 2
        tickets = [await wait(c.submit(kernels[n][which], xs))
                   for n, xs in trace[:half]]
        for i, t in enumerate(tickets):
            got[i] = await wait(c.result(t))
        rest = [await wait(c.submit(kernels[n][which], xs))
                for n, xs in trace[half:]]
        stream = {}

        async def collect():
            async for t, outs in c.results():
                stream[t] = outs
                if len(stream) == len(rest):
                    return

        await wait(collect())
        for i, t in enumerate(rest):
            got[half + i] = stream[t]
        codec = c.codec
    return got, codec


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("pair", ("jax_client-port_server",
                                  "port_client-jax_server"))
def test_cross_pairs_over_loopback(kernels, monkeypatch, pair, codec):
    client_mod, server_mod, which = ((jsock, tsock, 0)
                                     if pair.startswith("jax_client")
                                     else (tsock, jsock, 1))
    if codec == "msgpack":
        pytest.importorskip("msgpack")
    monkeypatch.setattr(client_mod, "CODECS", (codec,))
    trace = _trace(12, seed=3)
    want = _jax_oracle(kernels, trace)

    async def main():
        async with _server(server_mod) as srv:
            got, used = await _drive(client_mod, srv.port, kernels, trace,
                                     which)
            st = srv.stats()
            assert st["wire_rejects"] == 0
            assert st["registered_kernels"] == len({n for n, _ in trace})
            if server_mod is tsock:
                check_stats("socket", st)
            return got, used

    got, used = run(main())
    assert used == codec
    for i in range(len(trace)):
        for y in got[i]:
            assert y.dtype == np.float32
        _same(got[i], want[i], f"{pair} {codec} request {i}")


def test_wire_helpers_match_the_reference(kernels):
    for name in NAMES:
        dfg = jbench.benchmark(name)
        wire = jsock.dfg_to_wire(dfg)
        assert tsock.dfg_to_wire(tbench.benchmark(name)) == wire
        back = toverlay.compile_program(tsock.dfg_from_wire(wire))
        # the key the server checks at registration: name + digest
        assert (tbank.context_key(back.program)
                == jbank.context_key(kernels[name][0].program))
    assert set(tsock.__all__) == set(jsock.__all__)


def test_bfloat16_frames_name_float32_on_the_port(kernels):
    """The known wire difference, pinned: a bfloat16 fleet of the port
    delivers float32 arrays (its frames name ``float32``), the
    reference's deliver ``bfloat16``; widened, the values are equal bit
    for bit."""
    import jax.numpy as jnp
    trace = _trace(4, seed=8)
    got = {}
    for mod, kw, which in ((tsock, {"dtype": torch.bfloat16}, 1),
                           (jsock, {"dtype": jnp.bfloat16}, 0)):
        async def main():
            async with _server(mod, kw) as srv:
                return (await _drive(tsock, srv.port, kernels, trace,
                                     which))[0]
        got[mod.__name__] = run(main())
    port, ref = got[tsock.__name__], got[jsock.__name__]
    for i in range(len(trace)):
        for p, r in zip(port[i], ref[i]):
            assert p.dtype == np.float32
            assert r.dtype.name == "bfloat16"
            assert_same_bits(p, r.astype(np.float32), f"request {i}")
