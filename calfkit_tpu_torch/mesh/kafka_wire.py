"""Native Kafka wire-protocol client + MeshTransport (zero deps).

The port's own copy of ``calfkit_tpu.mesh.kafka_wire``: an
asyncio client speaking the REAL Kafka wire protocol — RecordBatch v2
(crc32c, zigzag varints), consumer groups with generations and
client-side range assignment, offset commit/fetch — against any
Kafka-compatible broker: the in-repo ``native/bin/kafkad``, or a real
Kafka/Redpanda cluster.

API versions spoken (fixed, non-flexible — accepted by kafkad and by
real brokers): ApiVersions v0, Metadata v1, Produce v3, Fetch v4,
ListOffsets v1, FindCoordinator v0, JoinGroup v2, SyncGroup v1,
Heartbeat v1, LeaveGroup v1, OffsetCommit v2, OffsetFetch v1,
CreateTopics v0.

``KafkaWireMesh`` maps the transport contract onto it (ACK-first
auto-commit, broadcast taps from latest, key-ordered dispatch) with zero
third-party dependencies.  Keys land on the partitions the JAX package's
client picks (the same murmur2), so both packages can share one topic.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
import logging
import os
import ssl as ssl_module
import struct
import time
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Mapping

from calfkit_tpu_torch.mesh.connection import DEFAULT_MAX_MESSAGE_BYTES
from calfkit_tpu_torch.protocol import header_map as protocol_header_map
from calfkit_tpu_torch.mesh.dispatch import KeyOrderedDispatcher
from calfkit_tpu_torch.mesh.tables import TableReader, TableWriter
from calfkit_tpu_torch.mesh.transport import (
    CallbackSubscription,
    MeshTransport,
    Record,
    RecordHandler,
    Subscription,
)

logger = logging.getLogger(__name__)

def find_kafkad() -> str | None:
    """Locate the in-repo native broker binary ($CALFKIT_KAFKAD overrides)."""
    from calfkit_tpu_torch.mesh._native import find_native_binary

    return find_native_binary("kafkad", "CALFKIT_KAFKAD")


def spawn_kafkad(port: int = 0, *, start_new_session: bool = False,
                 sasl: str | None = None, advertise_port: int | None = None,
                 log_dir: str | None = None):
    """Spawn the native Kafka-wire broker; port 0 = OS-assigned (reported
    on stdout as ``PORT <n>``, exposed as ``proc.kafkad_port``).
    ``sasl="user:pass"`` requires SASL/PLAIN from every connection;
    ``advertise_port`` is the ``advertised.listeners`` equivalent (what
    metadata/find_coordinator report — set it when a TLS terminator or
    port-forward sits in front of the broker); ``log_dir`` turns on the
    append-only WAL: topics, records, and committed offsets survive a
    broker restart (without it retention is memory-only)."""
    from calfkit_tpu_torch.mesh._native import spawn_port_reporting

    binary = find_kafkad()
    if binary is None:
        raise FileNotFoundError(
            "kafkad binary not found: run `make -C native` or set "
            "CALFKIT_KAFKAD"
        )
    extra: list[str] = []
    if sasl:
        extra += ["--sasl", sasl]
    if advertise_port:
        extra += ["--advertise-port", str(advertise_port)]
    if log_dir:
        extra += ["--log-dir", str(log_dir)]
    proc, bound = spawn_port_reporting(
        binary, port, name="kafkad", start_new_session=start_new_session,
        extra_args=extra,
    )
    proc.kafkad_port = bound  # type: ignore[attr-defined]
    return proc


# ------------------------------------------------------------------ crc32c
_CRC_TABLE: list[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (0x82F63B78 ^ (_c >> 1)) if (_c & 1) else (_c >> 1)
    _CRC_TABLE.append(_c)


def _crc32c_py(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _load_crc32c():
    """Prefer the in-repo native library (SSE4.2 / slice-by-8 — memory
    speed) so always-on CRC verification can't stall the event loop; the
    pure-Python table is the dependency-free fallback."""
    try:
        from calfkit_tpu_torch.mesh._native import find_native_binary

        path = find_native_binary("libcrc32c.so", "CALFKIT_CRC32C")
        if path is None:
            return _crc32c_py
        import ctypes

        lib = ctypes.CDLL(path)
        lib.calfkit_crc32c.restype = ctypes.c_uint32
        lib.calfkit_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        fn = lib.calfkit_crc32c
        if fn(b"123456789", 9) != 0xE3069283:  # self-check before trusting
            return _crc32c_py

        def _crc32c_native(data: bytes) -> int:
            return fn(data, len(data))

        return _crc32c_native
    except Exception:  # noqa: BLE001
        return _crc32c_py


crc32c = _load_crc32c()

# largest record_set decoded ON the event loop: with native crc32c the
# whole decode is memory-speed; the pure-Python fallback (~100 ns/byte)
# gets a much lower bar so crc verification can't starve heartbeats
_SYNC_DECODE_MAX = 65536 if crc32c.__name__ == "_crc32c_native" else 8192


# keys + header bytes get their own budget alongside the value budget —
# the fetch floor covers both, so the biggest legal RECORD always fits
KEY_HEADERS_CAP = 1024 * 1024


def fetch_floor(max_message_bytes: int) -> int:
    """The consumer fetch budget implied by the producer message budget
    (the ConnectionProfile coordinated-knob law): floored at 4 MiB, and
    always max_message_bytes + the key/headers cap + framing headroom so
    the biggest legal record is always fetchable."""
    return max(
        4 * 1024 * 1024, max_message_bytes + KEY_HEADERS_CAP + 64 * 1024
    )


async def _decode_off_loop(blob: bytes):
    """Decode a fetch's record_set, moving big blobs to a worker thread
    (mirrors the publish path's encode offload)."""
    if len(blob) > _SYNC_DECODE_MAX:
        return await asyncio.to_thread(decode_record_batches, blob)
    return decode_record_batches(blob)


# ------------------------------------------------------------------ codecs
class _W:
    __slots__ = ("parts",)

    def __init__(self):
        self.parts: list[bytes] = []

    def i8(self, v: int): self.parts.append(struct.pack(">b", v))
    def i16(self, v: int): self.parts.append(struct.pack(">h", v))
    def i32(self, v: int): self.parts.append(struct.pack(">i", v))
    def i64(self, v: int): self.parts.append(struct.pack(">q", v))
    def raw(self, b: bytes): self.parts.append(b)

    def varlong(self, v: int):
        z = (v << 1) ^ (v >> 63) if v < 0 else v << 1
        z &= (1 << 64) - 1
        out = bytearray()
        while z >= 0x80:
            out.append((z & 0x7F) | 0x80)
            z >>= 7
        out.append(z)
        self.parts.append(bytes(out))

    def string(self, s: str | None):
        if s is None:
            self.i16(-1)
        else:
            raw = s.encode("utf-8")
            self.i16(len(raw))
            self.raw(raw)

    def bytes_(self, b: bytes | None):
        if b is None:
            self.i32(-1)
        else:
            self.i32(len(b))
            self.raw(b)

    def done(self) -> bytes:
        return b"".join(self.parts)


class _R:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def i8(self) -> int:
        v = struct.unpack_from(">b", self.buf, self.pos)[0]
        self.pos += 1
        return v

    def i16(self) -> int:
        v = struct.unpack_from(">h", self.buf, self.pos)[0]
        self.pos += 2
        return v

    def i32(self) -> int:
        v = struct.unpack_from(">i", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def i64(self) -> int:
        v = struct.unpack_from(">q", self.buf, self.pos)[0]
        self.pos += 8
        return v

    def varlong(self) -> int:
        z = 0
        shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            z |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (z >> 1) ^ -(z & 1)

    def string(self) -> str:
        n = self.i16()
        if n < 0:
            return ""
        s = self.buf[self.pos:self.pos + n].decode("utf-8", errors="replace")
        self.pos += n
        return s

    def bytes_(self) -> bytes | None:
        n = self.i32()
        if n < 0:
            return None
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b


def encode_record_batch(
    records: "list[tuple[bytes | None, bytes | None, list[tuple[str, bytes]]]]",
    timestamp_ms: int,
) -> bytes:
    """[(key, value, headers)] → one RecordBatch v2 blob (baseOffset 0 —
    the broker assigns real offsets)."""
    recs = _W()
    for i, (key, value, headers) in enumerate(records):
        body = _W()
        body.i8(0)            # record attributes
        body.varlong(0)       # timestampDelta
        body.varlong(i)       # offsetDelta
        if key is None:
            body.varlong(-1)
        else:
            body.varlong(len(key))
            body.raw(key)
        if value is None:
            body.varlong(-1)
        else:
            body.varlong(len(value))
            body.raw(value)
        body.varlong(len(headers))
        for hk, hv in headers:
            hkb = hk.encode("utf-8")
            body.varlong(len(hkb))
            body.raw(hkb)
            body.varlong(len(hv))
            body.raw(hv)
        blob = body.done()
        recs.varlong(len(blob))
        recs.raw(blob)
    recblob = recs.done()

    crcbody = _W()
    crcbody.i16(0)                       # attributes (no compression)
    crcbody.i32(len(records) - 1)        # lastOffsetDelta
    crcbody.i64(timestamp_ms)
    crcbody.i64(timestamp_ms)
    crcbody.i64(-1)                      # producerId
    crcbody.i16(-1)                      # producerEpoch
    crcbody.i32(-1)                      # baseSequence
    crcbody.i32(len(records))
    crcbody.raw(recblob)
    crcblob = crcbody.done()

    crc = crc32c(crcblob)
    out = _W()
    out.i64(0)                           # baseOffset
    out.i32(4 + 1 + 4 + len(crcblob))    # batchLength
    out.i32(0)                           # partitionLeaderEpoch
    out.i8(2)                            # magic
    out.i32(crc - (1 << 32) if crc >= (1 << 31) else crc)
    out.raw(crcblob)
    return out.done()


_COMPRESSION_NAMES = {1: "gzip", 2: "snappy", 3: "lz4", 4: "zstd"}


def _decompress_records(codec: int, payload: bytes) -> bytes:
    """Inflate a compressed RecordBatch records-section (real brokers —
    kafkad and this module's producer never compress).  gzip rides the
    stdlib; the other codecs raise loudly instead of mis-parsing."""
    if codec == 1:
        import gzip

        try:
            return gzip.decompress(payload)
        except Exception as exc:  # noqa: BLE001 — BadGzipFile/zlib.error/EOFError
            raise RecordBatchError(f"corrupt gzip RecordBatch: {exc}") from exc
    name = _COMPRESSION_NAMES.get(codec, f"codec-{codec}")
    raise RecordBatchError(
        f"compressed RecordBatch ({name}) unsupported by the native wire "
        f"client — configure the producing side for gzip or no compression"
    )


def decode_record_batches(
    blob: bytes,
) -> "list[tuple[int, int, bytes | None, bytes | None, list[tuple[str, bytes]]]]":
    """Fetch record_set → [(offset, timestamp_ms, key, value, headers)].

    A truncated TRAILING batch (broker max_bytes cut) is dropped silently
    per the Kafka contract; corruption anywhere else raises a typed
    :class:`RecordBatchError` instead of a raw struct/index error."""
    out = []
    r = _R(blob)
    n = len(blob)
    while r.pos + 61 <= n:  # minimal batch header size
        base_offset = r.i64()
        batch_len = r.i32()
        batch_end = r.pos + batch_len
        if batch_end > n:
            break  # truncated trailing batch (broker max_bytes cut)
        if batch_len < 9:  # can't even hold epoch+magic+crc in any format
            raise RecordBatchError(f"batchLength {batch_len} not plausible")
        try:
            r.i32()  # partitionLeaderEpoch
            magic = r.i8()
            if magic != 2:
                # legacy v0/v1 message-set entry (magic shares this offset
                # across all formats): skip cleanly, don't size-check it
                r.pos = batch_end
                continue
            if batch_len < 49:  # smaller than the v2 header that must follow
                raise RecordBatchError(
                    f"batchLength {batch_len} below header size"
                )
            crc = r.i32() & 0xFFFFFFFF
            # crc covers attrs..end; verified on EVERY batch (native crc32c
            # makes this memory-speed) so a corrupt frame raises typed
            # instead of decoding to garbage records
            if crc32c(r.buf[r.pos:batch_end]) != crc:
                raise RecordBatchError("RecordBatch crc32c mismatch")
            attrs = r.i16()
            r.i32()  # lastOffsetDelta
            first_ts = r.i64()
            r.i64()  # maxTimestamp
            r.i64()  # producerId
            r.i16()  # producerEpoch
            r.i32()  # baseSequence
            count = r.i32()
            codec = attrs & 0x07
            if codec:
                rr = _R(_decompress_records(codec, r.buf[r.pos:batch_end]))
            else:
                rr = r
            for _ in range(count):
                rec_len = rr.varlong()
                rec_end = rr.pos + rec_len
                if rec_len < 0 or rec_end > len(rr.buf):
                    raise RecordBatchError(f"record length {rec_len} overruns batch")
                rr.i8()  # attributes
                ts_delta = rr.varlong()
                off_delta = rr.varlong()
                klen = rr.varlong()
                key = None
                if klen >= 0:
                    key = rr.buf[rr.pos:rr.pos + klen]
                    rr.pos += klen
                vlen = rr.varlong()
                value = None
                if vlen >= 0:
                    value = rr.buf[rr.pos:rr.pos + vlen]
                    rr.pos += vlen
                headers = []
                hcount = rr.varlong()
                if hcount < 0:
                    raise RecordBatchError(f"negative header count {hcount}")
                for _ in range(hcount):
                    hklen = rr.varlong()
                    hk = rr.buf[rr.pos:rr.pos + hklen].decode("utf-8", "replace")
                    rr.pos += hklen
                    hvlen = rr.varlong()
                    hv = b""
                    if hvlen >= 0:
                        hv = rr.buf[rr.pos:rr.pos + hvlen]
                        rr.pos += hvlen
                    headers.append((hk, hv))
                if rr.pos > rec_end:
                    raise RecordBatchError("record fields overran record length")
                rr.pos = rec_end
                out.append(
                    (base_offset + off_delta, first_ts + ts_delta, key, value,
                     headers)
                )
        except (struct.error, IndexError) as exc:
            raise RecordBatchError(f"corrupt RecordBatch: {exc}") from exc
        r.pos = batch_end
    return out


def murmur2(data: bytes) -> int:
    """Kafka's default partitioner hash (murmur2, seed 0x9747b28c)."""
    length = len(data)
    seed = 0x9747B28C
    m = 0x5BD1E995
    mask = 0xFFFFFFFF
    h = (seed ^ length) & mask
    i = 0
    while length - i >= 4:
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * m) & mask
        k ^= k >> 24
        k = (k * m) & mask
        h = (h * m) & mask
        h ^= k
        i += 4
    rem = length - i
    if rem == 3:
        h ^= data[i + 2] << 16
    if rem >= 2:
        h ^= data[i + 1] << 8
    if rem >= 1:
        h ^= data[i]
        h = (h * m) & mask
    h ^= h >> 13
    h = (h * m) & mask
    h ^= h >> 15
    return h


def partition_for(key: bytes | None, n: int, counter: list[int]) -> int:
    if key is None:
        counter[0] = (counter[0] + 1) % n
        return counter[0]
    return (murmur2(key) & 0x7FFFFFFF) % n


# --------------------------------------------------------------- security
_SUPPORTED_PROTOCOLS = ("PLAINTEXT", "SSL", "SASL_PLAINTEXT", "SASL_SSL")
_SUPPORTED_MECHANISMS = ("PLAIN", "SCRAM-SHA-256", "SCRAM-SHA-512")
_SECURITY_KEYS = (
    "security_protocol", "ssl_context", "sasl_mechanism",
    "sasl_plain_username", "sasl_plain_password",
)


@dataclass(frozen=True)
class WireSecurity:
    """The wire client's security config, parsed from the same
    aiokafka-style ``security=`` mapping :class:`ConnectionProfile`
    carries (SSL/SASL threaded through every client the same way).  Anything the native
    client cannot honor fails LOUDLY at construction — a secured cluster
    must never be contacted with security silently dropped."""

    protocol: str = "PLAINTEXT"
    ssl_context: "ssl_module.SSLContext | None" = None
    sasl_mechanism: str | None = None
    username: str | None = None
    password: str | None = None

    @property
    def uses_tls(self) -> bool:
        return self.protocol in ("SSL", "SASL_SSL")

    @property
    def uses_sasl(self) -> bool:
        return self.protocol in ("SASL_PLAINTEXT", "SASL_SSL")

    @classmethod
    def from_security_kwargs(cls, security: "Mapping[str, Any]") -> "WireSecurity":
        unknown = sorted(set(security) - set(_SECURITY_KEYS))
        if unknown:
            raise ValueError(
                f"security keys {unknown} are not supported by the native "
                f"kafka wire client (supported: {list(_SECURITY_KEYS)}); "
                "supply supported keys or terminate security out-of-process"
            )
        protocol = str(security.get("security_protocol", "PLAINTEXT")).upper()
        if protocol not in _SUPPORTED_PROTOCOLS:
            raise ValueError(
                f"security_protocol {protocol!r} unsupported by the native "
                f"wire client (supported: {list(_SUPPORTED_PROTOCOLS)})"
            )
        mechanism = security.get("sasl_mechanism")
        if mechanism is not None:
            mechanism = str(mechanism).upper()
            if mechanism not in _SUPPORTED_MECHANISMS:
                raise ValueError(
                    f"sasl_mechanism {mechanism!r} unsupported by the native "
                    f"wire client (supported: {list(_SUPPORTED_MECHANISMS)}); "
                    "GSSAPI/OAUTHBEARER need an out-of-process authenticator"
                )
        out = cls(
            protocol=protocol,
            ssl_context=security.get("ssl_context"),
            sasl_mechanism=mechanism,
            username=security.get("sasl_plain_username"),
            password=security.get("sasl_plain_password"),
        )
        if out.ssl_context is not None and not out.uses_tls:
            raise ValueError(
                f"ssl_context given but security_protocol is {protocol} — "
                "use SSL or SASL_SSL (refusing to connect in cleartext "
                "when TLS material was supplied)"
            )
        if out.uses_sasl:
            if not out.sasl_mechanism:
                raise ValueError(f"{protocol} requires sasl_mechanism")
            if out.username is None or out.password is None:
                raise ValueError(
                    f"{protocol} requires sasl_plain_username and "
                    "sasl_plain_password"
                )
        elif out.sasl_mechanism:
            raise ValueError(
                "sasl_mechanism given but security_protocol is "
                f"{protocol} (use SASL_PLAINTEXT or SASL_SSL)"
            )
        return out

    def resolved_ssl_context(self) -> "ssl_module.SSLContext | None":
        if not self.uses_tls:
            return None
        return self.ssl_context or ssl_module.create_default_context()


PLAINTEXT = WireSecurity()


class ScramClient:
    """RFC 5802 SCRAM client (SHA-256 / SHA-512), stdlib only.

    Three-message exchange: ``first()`` → server-first → ``final()`` →
    server-final → ``verify()`` (which authenticates the SERVER — a
    man-in-the-middle cannot forge the v= signature without the password).
    """

    def __init__(self, mechanism: str, username: str, password: str,
                 cnonce: str | None = None):
        self._hash = {
            "SCRAM-SHA-256": hashlib.sha256,
            "SCRAM-SHA-512": hashlib.sha512,
        }[mechanism]
        self._username = username
        self._password = password.encode("utf-8")
        self._cnonce = cnonce or base64.b64encode(os.urandom(24)).decode()
        self._first_bare = ""
        self._auth_message = b""
        self._salted = b""

    @staticmethod
    def _escape(name: str) -> str:
        return name.replace("=", "=3D").replace(",", "=2C")

    def first(self) -> bytes:
        self._first_bare = f"n={self._escape(self._username)},r={self._cnonce}"
        return ("n,," + self._first_bare).encode("utf-8")

    def final(self, server_first: bytes) -> bytes:
        text = server_first.decode("utf-8")
        fields = dict(f.split("=", 1) for f in text.split(","))
        snonce, salt_b64, iterations = fields["r"], fields["s"], int(fields["i"])
        if not snonce.startswith(self._cnonce):
            raise KafkaWireError("scram: server nonce does not extend ours", -1)
        self._salted = hashlib.pbkdf2_hmac(
            self._hash().name, self._password,
            base64.b64decode(salt_b64), iterations,
        )
        client_key = hmac.new(self._salted, b"Client Key", self._hash).digest()
        stored_key = self._hash(client_key).digest()
        without_proof = f"c=biws,r={snonce}"
        self._auth_message = ",".join(
            [self._first_bare, text, without_proof]
        ).encode("utf-8")
        client_sig = hmac.new(stored_key, self._auth_message, self._hash).digest()
        proof = bytes(a ^ b for a, b in zip(client_key, client_sig))
        return (
            without_proof + ",p=" + base64.b64encode(proof).decode()
        ).encode("utf-8")

    def verify(self, server_final: bytes) -> None:
        text = server_final.decode("utf-8")
        fields = dict(f.split("=", 1) for f in text.split(","))
        if "e" in fields:
            raise KafkaWireError(f"scram: server error {fields['e']}", -1)
        server_key = hmac.new(self._salted, b"Server Key", self._hash).digest()
        expected = hmac.new(server_key, self._auth_message, self._hash).digest()
        if base64.b64decode(fields["v"]) != expected:
            raise KafkaWireError("scram: server signature mismatch", -1)


# --------------------------------------------------------------- protocol
class KafkaWireError(Exception):
    def __init__(self, api: str, code: int):
        self.code = code
        super().__init__(f"{api} error_code={code}")


class RecordBatchError(KafkaWireError):
    """A RecordBatch that cannot be parsed safely (corrupt frame, crc
    mismatch, or a compression codec the native client does not speak)."""

    def __init__(self, message: str):
        self.code = -1
        Exception.__init__(self, message)


ERR_OFFSET_OUT_OF_RANGE = 1
ERR_REBALANCE_IN_PROGRESS = 27
ERR_ILLEGAL_GENERATION = 22
ERR_UNKNOWN_MEMBER = 25


class _Conn:
    """One broker connection; requests serialized (responses arrive in
    order per connection on every Kafka-compatible broker)."""

    def __init__(self, host: str, port: int, client_id: str = "calfkit",
                 security: WireSecurity = PLAINTEXT):
        self.host, self.port = host, port
        self.client_id = client_id
        self.security = security
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._lock = asyncio.Lock()
        self._correlation = 0

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port,
            ssl=self.security.resolved_ssl_context(),
        )
        self._correlation = 0
        if self.security.uses_sasl:
            try:
                await self._sasl_authenticate()
            except BaseException:
                # a half-authenticated connection must not stay installed:
                # the next request() would reuse it, skip connect(), and
                # surface an opaque read error instead of the auth failure
                self._drop()
                raise

    async def _sasl_authenticate(self) -> None:
        """SaslHandshake v1 + SaslAuthenticate v0 on the fresh connection
        (v1 handshake = tokens ride wrapped SaslAuthenticate frames)."""
        mechanism = self.security.sasl_mechanism or "PLAIN"
        w = _W()
        w.string(mechanism)
        r = await self._roundtrip(17, 1, w.done())
        err = r.i16()
        if err:
            raise KafkaWireError(f"sasl_handshake({mechanism})", err)

        async def auth_round(token: bytes) -> bytes:
            body = _W()
            body.bytes_(token)
            resp = await self._roundtrip(36, 0, body.done())
            code = resp.i16()
            message = resp.string()
            auth = resp.bytes_() or b""
            if code:
                raise KafkaWireError(
                    f"sasl_authenticate: {message or 'failed'}", code
                )
            return auth

        user = self.security.username or ""
        password = self.security.password or ""
        if mechanism == "PLAIN":
            await auth_round(
                b"\0" + user.encode("utf-8") + b"\0" + password.encode("utf-8")
            )
        else:
            scram = ScramClient(mechanism, user, password)
            server_first = await auth_round(scram.first())
            server_final = await auth_round(scram.final(server_first))
            scram.verify(server_final)

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass
            self._writer = None
            self._reader = None

    def _drop(self) -> None:
        """Abandon the connection WITHOUT awaiting (safe under
        cancellation): the next request() reconnects from a clean stream."""
        if self._writer is not None:
            self._writer.close()
            self._writer = None
            self._reader = None

    async def request(self, api_key: int, version: int, body: bytes) -> _R:
        async with self._lock:
            if self._writer is None:
                await self.connect()
            return await self._roundtrip(api_key, version, body)

    async def _roundtrip(self, api_key: int, version: int, body: bytes) -> _R:
        """One request/response on the live connection.  Callers hold the
        lock (request) or own the fresh connection (connect's SASL)."""
        self._correlation += 1
        header = _W()
        header.i16(api_key)
        header.i16(version)
        header.i32(self._correlation)
        header.string(self.client_id)
        payload = header.done() + body
        try:
            self._writer.write(struct.pack(">i", len(payload)) + payload)
            await self._writer.drain()
            szbuf = await self._reader.readexactly(4)
            size = struct.unpack(">i", szbuf)[0]
            blob = await self._reader.readexactly(size)
        except BaseException:
            # a cancellation (the fetch long-poll is where stop() lands)
            # or transport error mid-exchange leaves an unread response
            # in the stream — every later request would read the stale
            # frame and mis-correlate.  Drop the connection so the next
            # call starts clean.
            self._drop()
            raise
        r = _R(blob)
        correlation = r.i32()
        if correlation != self._correlation:
            self._drop()
            raise KafkaWireError("correlation-mismatch", -1)
        return r


ERR_NOT_LEADER = 6
ERR_NOT_COORDINATOR = 16


class KafkaWireClient:
    """Typed API calls with metadata-driven per-partition leader routing.

    One ``_Conn`` per broker address: produce/fetch/list_offsets go to the
    partition leader learned from Metadata, group APIs go to the group
    coordinator learned from FindCoordinator, everything else rides the
    bootstrap connection.  Against single-node brokers (kafkad) every
    route resolves to the bootstrap address and behavior is unchanged;
    against a spread-leader cluster each request lands on the right
    broker, with NOT_LEADER / NOT_COORDINATOR triggering a refresh +
    single retry."""

    def __init__(self, host: str, port: int, client_id: str = "calfkit",
                 security: WireSecurity = PLAINTEXT):
        self._client_id = client_id
        self._security = security
        self._conns: dict[tuple[str, int], _Conn] = {}
        self.conn = self._get_conn(host, port)  # bootstrap/control
        # routing state, refreshed from Metadata / FindCoordinator
        self._leaders: dict[tuple[str, int], tuple[str, int]] = {}
        self._coordinator: tuple[str, int] | None = None

    def _get_conn(self, host: str, port: int) -> _Conn:
        conn = self._conns.get((host, port))
        if conn is None:
            conn = _Conn(host, port, self._client_id, security=self._security)
            self._conns[(host, port)] = conn
        return conn

    def _leader_conn(self, topic: str, part: int) -> _Conn:
        addr = self._leaders.get((topic, part))
        return self._get_conn(*addr) if addr else self.conn

    def _coord_conn(self) -> _Conn:
        return (
            self._get_conn(*self._coordinator) if self._coordinator
            else self.conn
        )

    async def close(self) -> None:
        for conn in self._conns.values():
            await conn.close()

    async def metadata(self, topics: list[str] | None) -> dict:
        w = _W()
        if topics is None:
            w.i32(-1)
        else:
            w.i32(len(topics))
            for t in topics:
                w.string(t)
        r = await self.conn.request(3, 1, w.done())
        nbrokers = r.i32()
        brokers = []
        nodes: dict[int, tuple[str, int]] = {}
        for _ in range(nbrokers):
            node = r.i32()
            host = r.string()
            port = r.i32()
            r.string()  # rack
            brokers.append((node, host, port))
            nodes[node] = (host, port)
        r.i32()  # controller
        out: dict = {"brokers": brokers, "topics": {}}
        for _ in range(r.i32()):
            err = r.i16()
            name = r.string()
            r.i8()  # is_internal
            parts = []
            for _ in range(r.i32()):
                r.i16()  # partition error
                idx = r.i32()
                leader = r.i32()
                for _ in range(r.i32()):
                    r.i32()
                for _ in range(r.i32()):
                    r.i32()
                parts.append(idx)
                if leader in nodes:
                    self._leaders[(name, idx)] = nodes[leader]
                else:
                    self._leaders.pop((name, idx), None)  # leaderless
            out["topics"][name] = {"error": err, "partitions": sorted(parts)}
        return out

    async def _refresh_leaders(self, topics: "list[str]") -> None:
        try:
            await self.metadata(sorted(set(topics)))
        except Exception:  # noqa: BLE001 — routing refresh is best-effort
            logger.warning("kafka-wire metadata refresh failed", exc_info=True)

    async def create_topics(
        self, topics: list[str], partitions: int, *, compacted: bool = False
    ) -> dict[str, int]:
        w = _W()
        w.i32(len(topics))
        for name in topics:
            w.string(name)
            w.i32(partitions)
            w.i16(1)   # replication
            w.i32(0)   # manual assignments
            if compacted:
                w.i32(1)
                w.string("cleanup.policy")
                w.string("compact")
            else:
                w.i32(0)
        w.i32(10000)  # timeout
        r = await self.conn.request(19, 0, w.done())
        out = {}
        for _ in range(r.i32()):
            name = r.string()
            out[name] = r.i16()
        return out

    async def produce(
        self, topic: str, partition: int, batch: bytes
    ) -> int:
        w = _W()
        w.string(None)  # transactional_id
        w.i16(-1)       # acks=all
        w.i32(10000)
        w.i32(1)
        w.string(topic)
        w.i32(1)
        w.i32(partition)
        w.bytes_(batch)
        body = w.done()
        for attempt in (0, 1):
            conn = self._leader_conn(topic, partition)
            try:
                r = await conn.request(0, 3, body)
            except (OSError, EOFError):
                # leader connection died (EOFError covers the clean-close
                # IncompleteReadError signature): re-learn topology once
                if attempt == 0 and conn is not self.conn:
                    await self._refresh_leaders([topic])
                    continue
                raise
            base = -1
            err = 0
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    r.i32()  # partition
                    err = r.i16()
                    base = r.i64()
                    r.i64()  # log_append_time
            if err == ERR_NOT_LEADER and attempt == 0:
                await self._refresh_leaders([topic])
                continue
            if err:
                raise KafkaWireError("produce", err)
            return base
        # unreachable: attempt 1 always returned or raised above
        raise AssertionError("produce retry loop exhausted")

    async def _fetch_on(
        self, conn: _Conn, wants: "list[tuple[str, int, int]]",
        max_wait_ms: int, max_bytes: int,
    ) -> "list[tuple[str, int, int, bytes]]":
        w = _W()
        w.i32(-1)            # replica
        w.i32(max_wait_ms)
        w.i32(1)             # min_bytes
        w.i32(max_bytes)
        w.i8(0)              # isolation
        by_topic: dict[str, list[tuple[int, int]]] = {}
        for topic, part, off in wants:
            by_topic.setdefault(topic, []).append((part, off))
        w.i32(len(by_topic))
        for topic, parts in by_topic.items():
            w.string(topic)
            w.i32(len(parts))
            for part, off in parts:
                w.i32(part)
                w.i64(off)
                w.i32(max_bytes)
        r = await conn.request(1, 4, w.done())
        r.i32()  # throttle
        out = []
        for _ in range(r.i32()):
            topic = r.string()
            for _ in range(r.i32()):
                part = r.i32()
                err = r.i16()
                r.i64()  # high watermark
                r.i64()  # last stable
                naborted = r.i32()
                for _ in range(max(0, naborted)):
                    r.i64()
                    r.i64()
                blob = r.bytes_()
                out.append((topic, part, err, blob or b""))
        return out

    async def fetch(
        self,
        wants: "list[tuple[str, int, int]]",
        *,
        max_wait_ms: int = 300,
        max_bytes: int = 4 * 1024 * 1024,
    ) -> "list[tuple[str, int, int, bytes]]":
        """wants: [(topic, partition, offset)] →
        [(topic, partition, error, record_set)] — one request per leader
        broker, long-polled concurrently."""
        if not wants:
            return []
        by_conn: dict[_Conn, list[tuple[str, int, int]]] = {}
        for topic, part, off in wants:
            by_conn.setdefault(self._leader_conn(topic, part), []).append(
                (topic, part, off)
            )
        if len(by_conn) <= 1:
            conn, conn_wants = next(iter(by_conn.items()))
            out = await self._fetch_on(conn, conn_wants, max_wait_ms, max_bytes)
        else:
            chunks = await asyncio.gather(*(
                self._fetch_on(conn, conn_wants, max_wait_ms, max_bytes)
                for conn, conn_wants in by_conn.items()
            ), return_exceptions=True)
            out = []
            first_error: BaseException | None = None
            for chunk in chunks:
                if isinstance(chunk, BaseException):
                    first_error = first_error or chunk
                else:
                    out.extend(chunk)
            if first_error is not None:
                # a dead leader poisons only its chunk; re-learn topology
                # and surface the failure (the consume loop retries)
                await self._refresh_leaders(
                    sorted({t for t, *_x in wants})
                )
                if not out:
                    raise first_error
        stale = [
            (topic, part) for topic, part, err, _b in out
            if err == ERR_NOT_LEADER
        ]
        if stale:
            for tp in stale:
                self._leaders.pop(tp, None)
            await self._refresh_leaders(sorted({t for t, _p in stale}))
        return out

    async def list_offsets(
        self, wants: "list[tuple[str, int]]", *, earliest: bool = False
    ) -> dict:
        by_conn: dict[_Conn, list[tuple[str, int]]] = {}
        for topic, part in wants:
            by_conn.setdefault(self._leader_conn(topic, part), []).append(
                (topic, part)
            )

        async def one(conn: _Conn, conn_wants: "list[tuple[str, int]]") -> dict:
            w = _W()
            w.i32(-1)
            by_topic: dict[str, list[int]] = {}
            for topic, part in conn_wants:
                by_topic.setdefault(topic, []).append(part)
            w.i32(len(by_topic))
            for topic, parts in by_topic.items():
                w.string(topic)
                w.i32(len(parts))
                for part in parts:
                    w.i32(part)
                    w.i64(-2 if earliest else -1)
            r = await conn.request(2, 1, w.done())
            found: dict = {}
            for _ in range(r.i32()):
                topic = r.string()
                for _ in range(r.i32()):
                    part = r.i32()
                    err = r.i16()
                    r.i64()  # timestamp
                    off = r.i64()
                    if not err:
                        found[(topic, part)] = off
            return found

        out: dict = {}
        # concurrent like fetch(): barrier/position-resolve sits on the
        # worker-startup hot path — pay max(RTT), not sum(RTT)
        for found in await asyncio.gather(
            *(one(conn, ws) for conn, ws in by_conn.items())
        ):
            out.update(found)
        return out

    async def find_coordinator(self, group: str) -> tuple[str, int]:
        w = _W()
        w.string(group)
        r = await self.conn.request(10, 0, w.done())
        err = r.i16()
        if err:
            raise KafkaWireError("find_coordinator", err)
        r.i32()  # node
        host, port = r.string(), r.i32()
        self._coordinator = (host, port)
        return host, port

    async def ensure_coordinator(self, group: str) -> None:
        """Resolve + cache the group coordinator so group APIs route to
        it (real clusters host a group on ONE broker; kafkad reports
        itself)."""
        if self._coordinator is None:
            await self.find_coordinator(group)

    def forget_coordinator(self) -> None:
        self._coordinator = None

    async def join_group(
        self, group: str, member_id: str, topics: list[str],
        *, session_timeout_ms: int = 10000, rebalance_timeout_ms: int = 10000,
    ) -> dict:
        meta = _W()
        meta.i16(0)  # consumer-protocol version
        meta.i32(len(topics))
        for t in topics:
            meta.string(t)
        meta.bytes_(b"")  # userdata
        w = _W()
        w.string(group)
        w.i32(session_timeout_ms)
        w.i32(rebalance_timeout_ms)
        w.string(member_id)
        w.string("consumer")
        w.i32(1)
        w.string("range")
        w.bytes_(meta.done())
        r = await self._coord_conn().request(11, 2, w.done())
        r.i32()  # throttle
        err = r.i16()
        if err:
            raise KafkaWireError("join_group", err)
        generation = r.i32()
        protocol = r.string()
        leader = r.string()
        me = r.string()
        members = {}
        for _ in range(r.i32()):
            mid = r.string()
            blob = r.bytes_() or b""
            mr = _R(blob)
            mr.i16()
            mtopics = [mr.string() for _ in range(mr.i32())]
            members[mid] = mtopics
        return {
            "generation": generation, "protocol": protocol,
            "leader": leader, "member_id": me, "members": members,
        }

    async def sync_group(
        self, group: str, generation: int, member_id: str,
        assignments: "dict[str, dict[str, list[int]]] | None" = None,
    ) -> dict[str, list[int]]:
        w = _W()
        w.string(group)
        w.i32(generation)
        w.string(member_id)
        if assignments:
            w.i32(len(assignments))
            for mid, parts_by_topic in assignments.items():
                w.string(mid)
                blob = _W()
                blob.i16(0)
                blob.i32(len(parts_by_topic))
                for topic, parts in parts_by_topic.items():
                    blob.string(topic)
                    blob.i32(len(parts))
                    for p in parts:
                        blob.i32(p)
                blob.bytes_(b"")  # userdata
                w.bytes_(blob.done())
        else:
            w.i32(0)
        r = await self._coord_conn().request(14, 1, w.done())
        r.i32()  # throttle
        err = r.i16()
        if err:
            raise KafkaWireError("sync_group", err)
        blob = r.bytes_() or b""
        if not blob:
            return {}
        ar = _R(blob)
        ar.i16()
        out: dict[str, list[int]] = {}
        for _ in range(ar.i32()):
            topic = ar.string()
            out[topic] = [ar.i32() for _ in range(ar.i32())]
        return out

    async def heartbeat(self, group: str, generation: int, member_id: str) -> int:
        w = _W()
        w.string(group)
        w.i32(generation)
        w.string(member_id)
        r = await self._coord_conn().request(12, 1, w.done())
        r.i32()  # throttle
        return r.i16()

    async def leave_group(self, group: str, member_id: str) -> None:
        w = _W()
        w.string(group)
        w.string(member_id)
        r = await self._coord_conn().request(13, 1, w.done())
        r.i32()
        r.i16()

    async def offset_commit(
        self, group: str, generation: int, member_id: str,
        offsets: "dict[tuple[str, int], int]",
    ) -> None:
        w = _W()
        w.string(group)
        w.i32(generation)
        w.string(member_id)
        w.i64(-1)  # retention
        by_topic: dict[str, list[tuple[int, int]]] = {}
        for (topic, part), off in offsets.items():
            by_topic.setdefault(topic, []).append((part, off))
        w.i32(len(by_topic))
        for topic, parts in by_topic.items():
            w.string(topic)
            w.i32(len(parts))
            for part, off in parts:
                w.i32(part)
                w.i64(off)
                w.string(None)  # metadata
        r = await self._coord_conn().request(8, 2, w.done())
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()
                err = r.i16()
                if err:
                    # a silently-failed commit (rebalance in flight against
                    # a real broker) would rewind the group on restart
                    raise KafkaWireError("offset_commit", err)

    async def offset_fetch(
        self, group: str, wants: "list[tuple[str, int]]"
    ) -> "dict[tuple[str, int], int]":
        w = _W()
        w.string(group)
        by_topic: dict[str, list[int]] = {}
        for topic, part in wants:
            by_topic.setdefault(topic, []).append(part)
        w.i32(len(by_topic))
        for topic, parts in by_topic.items():
            w.string(topic)
            w.i32(len(parts))
            for part in parts:
                w.i32(part)
        r = await self._coord_conn().request(9, 1, w.done())
        out = {}
        for _ in range(r.i32()):
            topic = r.string()
            for _ in range(r.i32()):
                part = r.i32()
                off = r.i64()
                r.string()  # metadata
                r.i16()
                if off >= 0:
                    out[(topic, part)] = off
        return out


# ------------------------------------------------------------- consumers
def range_assign(
    members: "dict[str, list[str]]", partitions: "dict[str, list[int]]"
) -> "dict[str, dict[str, list[int]]]":
    """The standard range assignor, computed CLIENT-side by the group
    leader (Kafka's embedded consumer protocol)."""
    out: dict[str, dict[str, list[int]]] = {m: {} for m in members}
    for topic, parts in sorted(partitions.items()):
        subscribed = sorted(m for m, ts in members.items() if topic in ts)
        if not subscribed:
            continue
        per = len(parts) // len(subscribed)
        extra = len(parts) % len(subscribed)
        idx = 0
        for i, member in enumerate(subscribed):
            take = per + (1 if i < extra else 0)
            if take:
                out[member][topic] = parts[idx:idx + take]
            idx += take
    return out


class _WireConsumer:
    """One subscription's consume loop: group-coordinated or groupless."""

    def __init__(
        self,
        host: str,
        port: int,
        topics: list[str],
        group_id: str | None,
        from_latest: bool,
        deliver: Callable[[Record], Awaitable[None]],
        *,
        session_timeout_ms: int = 10000,
        commit_interval_s: float = 1.0,
        security: WireSecurity = PLAINTEXT,
        max_message_bytes: int = DEFAULT_MAX_MESSAGE_BYTES,
        client_id: str = "calfkit-consumer",
    ):
        self._security = security
        # the coordinated-knob law (ConnectionProfile): the consumer fetch
        # budget must FLOOR at the producer message budget, or the biggest
        # legal message could never be fetched (brokers do return at least
        # one oversized message per fetch — KIP-74 — but honoring the
        # budget keeps multi-record batches flowing too)
        self._fetch_max_bytes = fetch_floor(max_message_bytes)
        self._client = KafkaWireClient(
            host, port, client_id=client_id, security=security
        )
        self._topics = topics
        self._group = group_id
        self._from_latest = from_latest
        self._deliver = deliver
        self._client_id = client_id
        self._session_ms = session_timeout_ms
        self._commit_interval = commit_interval_s
        self._positions: dict[tuple[str, int], int] = {}
        self._member_id = ""
        self._generation = -1
        self._group_had_no_partitions = False
        self._poison_logged: dict[tuple[str, int], float] = {}
        self._rejoin = asyncio.Event()
        self._stopped = False
        self._task: asyncio.Task[None] | None = None
        self._hb_task: asyncio.Task[None] | None = None
        self.started = asyncio.Event()  # first assignment ready

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(
            self._run(), name=f"kafka-wire-{self._group or 'tap'}"
        )

    async def stop(self) -> None:
        self._stopped = True
        if self._hb_task:
            self._hb_task.cancel()
        if self._task:
            self._task.cancel()
            for task in (self._hb_task, self._task):
                if task:
                    try:
                        await task
                    except (asyncio.CancelledError, Exception):  # noqa: BLE001
                        pass
        try:
            if self._group and self._positions:
                await self._client.offset_commit(
                    self._group, self._generation, self._member_id,
                    self._positions,
                )
            if self._group and self._member_id:
                await self._client.leave_group(self._group, self._member_id)
        except Exception:  # noqa: BLE001
            pass
        await self._client.close()

    async def _run(self) -> None:
        """Consume forever; transport errors (broker restart, idle reap)
        back off and retry instead of silently killing the subscription —
        the Subscription object stays live, so the loop must too."""
        while not self._stopped:
            try:
                if self._group is None:
                    await self._run_tap()
                else:
                    await self._run_group_cycle()
            except asyncio.CancelledError:
                raise
            except KafkaWireError as exc:
                if exc.code in (
                    ERR_REBALANCE_IN_PROGRESS,
                    ERR_ILLEGAL_GENERATION,
                    ERR_UNKNOWN_MEMBER,
                ):
                    continue  # rejoin immediately
                if exc.code == ERR_NOT_COORDINATOR:
                    # coordinator moved (real clusters): re-find + rejoin
                    self._client.forget_coordinator()
                    continue
                logger.warning(
                    "kafka-wire consumer error on %s: %s; retrying",
                    self._topics, exc,
                )
                await asyncio.sleep(1.0)
            except Exception:  # noqa: BLE001
                logger.exception(
                    "kafka-wire consumer error on %s; retrying", self._topics
                )
                await asyncio.sleep(1.0)

    async def _assignment_all_partitions(self) -> dict[tuple[str, int], None]:
        meta = await self._client.metadata(self._topics)
        return {
            (topic, part): None
            for topic, info in meta["topics"].items()
            for part in info["partitions"]
        }

    async def _resolve_tap_positions(self) -> None:
        assigned = list(await self._assignment_all_partitions())
        if not assigned:
            return
        offsets = await self._client.list_offsets(
            assigned, earliest=not self._from_latest
        )
        self._positions = {tp: offsets.get(tp, 0) for tp in assigned}

    async def _run_tap(self) -> None:
        if not self._positions:  # first attach; a retry keeps its positions
            await self._resolve_tap_positions()
        self.started.set()
        while not self._stopped:
            if not self._positions:
                # zero partitions at attach (auto-create off, or the topic
                # is created later): keep re-resolving instead of leaving
                # the subscription permanently dead while looking started
                await asyncio.sleep(1.0)
                await self._resolve_tap_positions()
                continue
            await self._fetch_once()

    async def _run_group_cycle(self) -> None:
        await self._client.ensure_coordinator(self._group)
        join = await self._client.join_group(
            self._group, self._member_id, self._topics,
            session_timeout_ms=self._session_ms,
            rebalance_timeout_ms=self._session_ms,
        )
        self._member_id = join["member_id"]
        self._generation = join["generation"]
        if join["member_id"] == join["leader"]:
            meta = await self._client.metadata(
                sorted({t for ts in join["members"].values() for t in ts})
            )
            partitions = {
                name: info["partitions"]
                for name, info in meta["topics"].items()
            }
            assignment = await self._client.sync_group(
                self._group, self._generation, self._member_id,
                range_assign(join["members"], partitions),
            )
        else:
            assignment = await self._client.sync_group(
                self._group, self._generation, self._member_id
            )
        assigned = [
            (topic, part)
            for topic, parts in assignment.items()
            for part in parts
        ]
        # distinguish "topic has no partitions anywhere" (watch for them to
        # appear) from "peers hold them all" (stay idle, keep membership)
        self._group_had_no_partitions = (
            not assigned and not await self._assignment_all_partitions()
        )
        committed = await self._client.offset_fetch(self._group, assigned)
        missing = [tp for tp in assigned if tp not in committed]
        if missing:
            fresh = await self._client.list_offsets(
                missing, earliest=not self._from_latest
            )
            committed.update({tp: fresh.get(tp, 0) for tp in missing})
        self._positions = committed
        self._rejoin.clear()
        self.started.set()
        # heartbeat rides its own task; REBALANCE_IN_PROGRESS flags rejoin
        self._hb_task = asyncio.get_running_loop().create_task(
            self._heartbeat_loop(), name=f"kafka-wire-hb-{self._group}"
        )
        last_commit = time.monotonic()
        last_empty_check = time.monotonic()
        try:
            while not self._stopped and not self._rejoin.is_set():
                if not self._positions:
                    # empty assignment: either the topic has no partitions
                    # yet (created later / auto-create off) or other members
                    # hold them all.  Re-check metadata on a slow cadence and
                    # force a rebalance ONLY when partitions newly appear —
                    # rejoining because peers hold the partitions would
                    # thrash the whole group.
                    await asyncio.sleep(0.5)
                    if (
                        self._group_had_no_partitions
                        and time.monotonic() - last_empty_check >= 5.0
                    ):
                        last_empty_check = time.monotonic()
                        if await self._assignment_all_partitions():
                            break  # partitions appeared → rejoin cycle
                    continue
                await self._fetch_once()
                if time.monotonic() - last_commit >= self._commit_interval:
                    # ACK-first auto-commit: cadence independent of handler
                    # completion (transport contract)
                    await self._client.offset_commit(
                        self._group, self._generation, self._member_id,
                        self._positions,
                    )
                    last_commit = time.monotonic()
        finally:
            self._hb_task.cancel()
            try:
                await self._hb_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._hb_task = None
            # commit-on-revoke: the NEXT generation's owner starts where
            # this one stopped
            if self._positions:
                try:
                    await self._client.offset_commit(
                        self._group, self._generation, self._member_id,
                        self._positions,
                    )
                except Exception:  # noqa: BLE001
                    pass

    async def _heartbeat_loop(self) -> None:
        interval = max(self._session_ms / 3000.0, 0.5)
        hb = KafkaWireClient(
            self._client.conn.host, self._client.conn.port,
            client_id=f"{self._client_id}-hb", security=self._security,
        )
        failures = 0
        try:
            while not self._stopped:
                await asyncio.sleep(interval)
                try:
                    await hb.ensure_coordinator(self._group)
                    code = await hb.heartbeat(
                        self._group, self._generation, self._member_id
                    )
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001
                    # transport error (broker restart, idle reap): retry
                    # with backoff; a persistent failure must force a rejoin
                    # instead of leaving the consumer fetching heartbeat-less
                    # until the session expires server-side
                    failures += 1
                    if failures >= 3:
                        logger.warning(
                            "kafka-wire heartbeat to group %s failing; "
                            "forcing rejoin", self._group,
                        )
                        self._rejoin.set()
                        return
                    await asyncio.sleep(min(0.25 * 2 ** failures, 2.0))
                    continue
                failures = 0
                if code == ERR_NOT_COORDINATOR:
                    hb.forget_coordinator()
                    continue
                if code in (
                    ERR_REBALANCE_IN_PROGRESS, ERR_ILLEGAL_GENERATION,
                    ERR_UNKNOWN_MEMBER,
                ):
                    self._rejoin.set()
                    return
        finally:
            await hb.close()

    def _poison_warn(self, topic: str, part: int, exc: Exception) -> None:
        """Log a poison batch loudly but at most once per ~30s per
        partition — the fetch loop retries it forever."""
        now = time.monotonic()
        last = self._poison_logged.get((topic, part), 0.0)
        if now - last >= 30.0:
            self._poison_logged[(topic, part)] = now
            logger.error(
                "kafka-wire: undecodable RecordBatch on %s[%d] at offset "
                "%s — partition stalled (will retry): %s",
                topic, part, self._positions.get((topic, part)), exc,
            )

    async def _fetch_once(self) -> None:
        if not self._positions:
            await asyncio.sleep(0.2)
            return
        wants = [
            (topic, part, off)
            for (topic, part), off in self._positions.items()
        ]
        results = await self._client.fetch(
            wants, max_wait_ms=300, max_bytes=self._fetch_max_bytes
        )
        for topic, part, err, blob in results:
            if err == ERR_OFFSET_OUT_OF_RANGE:
                # retention moved log-start past our position, or the
                # broker restarted with a shorter log (kafkad is
                # memory-only): re-resolve LOUDLY instead of silently
                # stalling the partition forever
                fresh = await self._client.list_offsets(
                    [(topic, part)], earliest=not self._from_latest
                )
                new_off = fresh.get((topic, part), 0)
                logger.warning(
                    "kafka-wire: %s[%d] position %s out of range; broker "
                    "log truncated or restarted — resetting to %s",
                    topic, part, self._positions.get((topic, part)), new_off,
                )
                self._positions[(topic, part)] = new_off
                continue
            if err:
                logger.warning(
                    "kafka-wire fetch error %d on %s[%d]; retrying",
                    err, topic, part,
                )
                await asyncio.sleep(0.2)
                continue
            if not blob:
                continue
            try:
                batches = await _decode_off_loop(blob)
            except RecordBatchError as exc:
                # poison batch (crc mismatch / unsupported codec): stall
                # THIS partition loudly without advancing past data, and
                # without propagating — propagation would exit the group
                # cycle and rebalance-thrash every member at ~1 Hz
                self._poison_warn(topic, part, exc)
                await asyncio.sleep(1.0)
                continue
            for off, ts_ms, key, value, headers in batches:
                position = self._positions.get((topic, part), 0)
                if off < position:
                    continue  # batch includes pre-position records
                record = Record(
                    topic=topic,
                    key=key,
                    value=value or b"",
                    # the protocol.header_map contract: undecodable header
                    # values are DROPPED, not replacement-char'd — a
                    # garbage x-mesh-trace must degrade to untraced, not
                    # mint a bogus trace id shared by every corrupt record
                    headers=protocol_header_map(dict(headers)),
                    offset=off,
                    timestamp=ts_ms / 1000.0,
                )
                self._positions[(topic, part)] = off + 1
                try:
                    await self._deliver(record)
                except Exception:  # noqa: BLE001
                    logger.exception("kafka-wire delivery failed on %s", topic)


# ------------------------------------------------------------- transport
class KafkaWireMesh(MeshTransport):
    """MeshTransport over the native wire client — the transport contract
    mapped onto Kafka's, zero third-party dependencies.  Points at any
    Kafka-compatible broker (``native/bin/kafkad`` in-image; real
    Kafka/Redpanda in production).

    Security rides the same :class:`ConnectionProfile` as the aiokafka
    adapter: TLS (``security_protocol="SSL"``), SASL PLAIN and
    SCRAM-SHA-256/512 (``SASL_PLAINTEXT`` / ``SASL_SSL``) are spoken
    natively; anything else fails loudly at construction.

    Multi-node clusters: produce/fetch/list_offsets route to each
    partition's leader and group APIs to the group coordinator, both
    learned from metadata with refresh-and-retry on NOT_LEADER /
    NOT_COORDINATOR — one client, any Kafka-compatible topology."""

    def __init__(
        self,
        bootstrap_servers: str | None = None,
        *,
        profile: "ConnectionProfile | None" = None,
        security: "Mapping[str, Any] | None" = None,
        max_message_bytes: int | None = None,
        default_partitions: int = 8,
    ):
        from calfkit_tpu_torch.mesh.connection import ConnectionProfile

        if profile is None:
            if not bootstrap_servers:
                raise ValueError("bootstrap_servers (or profile=) required")
            profile = ConnectionProfile(
                bootstrap_servers=bootstrap_servers,
                max_message_bytes=(
                    max_message_bytes if max_message_bytes is not None
                    else DEFAULT_MAX_MESSAGE_BYTES
                ),
                security=dict(security or {}),
            )
        else:
            # profile= owns every connection knob (same conflict rule as
            # the JAX package's): silently ignoring a kwarg would hide a config bug
            conflicts = [
                name for name, value in (
                    ("bootstrap_servers", bootstrap_servers),
                    ("security", security),
                    ("max_message_bytes", max_message_bytes),
                ) if value is not None
            ]
            if conflicts:
                raise ValueError(
                    f"profile= conflicts with {conflicts}: set these on the "
                    "ConnectionProfile instead"
                )
        self._profile = profile
        if profile.enable_idempotence:
            # retry-once produce (NOT_LEADER / dead-leader EOF) cannot
            # guarantee exactly-once sequencing; honoring the flag
            # silently as at-least-once would be a lie
            raise ValueError(
                "enable_idempotence=True is not supported by the native "
                "wire client (no idempotent-producer sequencing); unset it"
            )
        # parse EARLY so unsupported security fails at construction, not
        # first I/O
        self._security = WireSecurity.from_security_kwargs(profile.security)
        # "host:port[,host:port...]" — the FIRST entry seeds the bootstrap
        # connection; partition leaders and the group coordinator are then
        # learned from metadata and dialed directly.  A bare host defaults
        # to 9092.
        first = profile.bootstrap_servers.split(",")[0].strip()
        host, _, port = first.rpartition(":")
        if not host:
            host, port = first, ""
        self._host = host or "127.0.0.1"
        self._port = int(port) if port else 9092
        self._max_bytes = profile.max_message_bytes
        self._default_partitions = default_partitions
        self._producer: KafkaWireClient | None = None
        self._partition_counts: dict[str, int] = {}
        self._rr_counter = [0]
        self._consumers: list[_WireConsumer] = []
        self._dispatchers: list[KeyOrderedDispatcher] = []
        self._readers: list[_WireTableReader] = []
        self._started = False

    @property
    def max_message_bytes(self) -> int:
        return self._max_bytes

    @property
    def profile(self):
        return self._profile

    async def start(self) -> None:
        if self._started:
            return
        self._producer = KafkaWireClient(
            self._host, self._port,
            client_id=f"{self._profile.client_id}-producer",
            security=self._security,
        )
        await self._producer.conn.connect()
        # atomicity-ok: callers serialize start() (Client._ensure_started's
        # single-flight lock / worker boot); double start only re-dials the
        # producer conn
        self._started = True

    async def stop(self) -> None:
        self._started = False
        # swap-then-iterate (meshlint await-atomicity): detach before
        # the first await so a racing subscribe can't be silently dropped
        readers, self._readers = self._readers, []
        for reader in readers:
            try:
                await reader.stop()
            except Exception:  # noqa: BLE001
                logger.exception("table reader stop failed")
        consumers, self._consumers = self._consumers, []
        for consumer in consumers:
            try:
                await consumer.stop()
            except Exception:  # noqa: BLE001
                logger.exception("consumer stop failed")
        dispatchers, self._dispatchers = self._dispatchers, []
        for dispatcher in dispatchers:
            try:
                await dispatcher.stop()
            except Exception:  # noqa: BLE001
                logger.exception("dispatcher drain failed")
        if self._producer is not None:
            await self._producer.close()
            self._producer = None

    # ---------------------------------------------------------------- admin
    async def ensure_topics(
        self, names: list[str], *, compacted: bool = False
    ) -> None:
        if self._producer is None:
            raise RuntimeError("mesh not started")
        await self._producer.create_topics(
            names, self._default_partitions, compacted=compacted
        )

    async def _partitions_of(self, topic: str) -> int:
        count = self._partition_counts.get(topic)
        if count:
            return count
        meta = await self._producer.metadata([topic])
        count = max(1, len(meta["topics"].get(topic, {}).get("partitions", [])))
        self._partition_counts[topic] = count
        return count

    # -------------------------------------------------------------- produce
    async def publish(
        self,
        topic: str,
        value: bytes | None,
        *,
        key: bytes | None = None,
        headers: dict[str, str] | None = None,
    ) -> None:
        if value is not None and len(value) > self._max_bytes:
            raise ValueError(
                f"message of {len(value)} bytes exceeds "
                f"max_message_bytes={self._max_bytes}"
            )
        header_bytes = sum(
            len(hk.encode()) + len(hv.encode())
            for hk, hv in (headers or {}).items()
        )
        if len(key or b"") + header_bytes > KEY_HEADERS_CAP:
            raise ValueError(
                f"key+headers of {len(key or b'') + header_bytes} bytes "
                f"exceed the {KEY_HEADERS_CAP}-byte budget"
            )
        if self._producer is None:
            raise RuntimeError("mesh not started")
        # no mesh-wide lock: partition choice is synchronous, the metadata
        # lookup caches after the first call per topic, and _Conn already
        # serializes the wire — holding a lock across the produce RTT
        # would cap the whole transport at one in-flight message
        n = await self._partitions_of(topic)
        part = partition_for(key, n, self._rr_counter)
        records = [(
            key, value,
            [(hk, hv.encode("utf-8")) for hk, hv in (headers or {}).items()],
        )]
        now_ms = int(time.time() * 1000)
        if value is not None and len(value) > 65536:
            # the pure-Python crc32c over a multi-MiB payload would stall
            # the event loop (heartbeats, fetch long-polls); encode big
            # batches on a worker thread
            batch = await asyncio.to_thread(
                encode_record_batch, records, now_ms
            )
        else:
            batch = encode_record_batch(records, now_ms)
        await self._producer.produce(topic, part, batch)

    # -------------------------------------------------------------- consume
    async def subscribe(
        self,
        topics: list[str],
        handler: RecordHandler,
        *,
        group_id: str | None,
        from_latest: bool | None = None,
        max_workers: int = 8,
        ordered: bool = True,
    ) -> Subscription:
        if from_latest is None:
            from_latest = group_id is None
        deliver = handler
        dispatcher: KeyOrderedDispatcher | None = None
        if ordered:
            dispatcher = KeyOrderedDispatcher(
                handler, max_workers=max_workers,
                name=f"kafka-wire-{group_id or 'tap'}",
            )
            dispatcher.start()
            self._dispatchers.append(dispatcher)

            async def deliver(record: Record) -> None:  # type: ignore[misc]
                await dispatcher.submit(record)

        if self._producer is not None:
            # topics must exist before a groupless tap resolves "latest"
            await self._producer.metadata(topics)
        consumer = _WireConsumer(
            self._host, self._port, topics, group_id, from_latest, deliver,
            security=self._security, max_message_bytes=self._max_bytes,
            client_id=f"{self._profile.client_id}-consumer",
        )
        consumer.start()
        self._consumers.append(consumer)
        try:
            await asyncio.wait_for(consumer.started.wait(), timeout=30)
        except BaseException:
            # a failed subscribe must not leak a live consumer task (still
            # rejoining, still a group member) + a running dispatcher
            self._consumers.remove(consumer)
            await consumer.stop()
            if dispatcher is not None:
                await dispatcher.stop()
                self._dispatchers.remove(dispatcher)
            raise

        async def stop_fn() -> None:
            await consumer.stop()
            if consumer in self._consumers:
                self._consumers.remove(consumer)
            if dispatcher is not None:
                await dispatcher.stop()
                if dispatcher in self._dispatchers:
                    self._dispatchers.remove(dispatcher)

        return CallbackSubscription(stop_fn)

    # --------------------------------------------------------------- tables
    def table_reader(self, topic: str) -> TableReader:
        reader = _WireTableReader(self, topic)
        self._readers.append(reader)
        return reader

    def table_writer(self, topic: str) -> TableWriter:
        return _WireTableWriter(self, topic)


class _WireTableReader(TableReader):
    """Compacted-topic view over the wire client: consume-all into a dict
    with catch-up (end-offsets gate) and barrier semantics."""

    def __init__(self, mesh: KafkaWireMesh, topic: str):
        self._mesh = mesh
        self._topic = topic
        self._view: dict[str, bytes] = {}
        self._client: KafkaWireClient | None = None
        self._fetch_positions: dict[int, int] = {}
        self._fetch_max_bytes = fetch_floor(mesh.max_message_bytes)
        self._task: asyncio.Task[None] | None = None
        self._stopped = False
        self._advanced = asyncio.Event()
        self._caught_up = False
        # view-mutation counter (TableReader.version): bumps per applied
        # record and at every rebuild swap — the no-change fast path for
        # per-call readers (the fleet registry)
        self._version = 0

    async def start(self, *, timeout: float = 30.0) -> None:
        self._client = KafkaWireClient(
            self._mesh._host, self._mesh._port,
            client_id=f"{self._mesh._profile.client_id}-table",
            security=self._mesh._security,
        )
        # own fetch loop (not _WireConsumer): the barrier needs each
        # record's PARTITION, which the transport Record doesn't carry
        meta = await self._client.metadata([self._topic])
        parts = meta["topics"].get(self._topic, {}).get("partitions", [])
        self._fetch_positions = {p: 0 for p in parts}
        self._task = asyncio.get_running_loop().create_task(
            self._pump(), name=f"kafka-wire-table-{self._topic}"
        )
        try:
            await self.barrier(timeout=timeout)
        except BaseException:
            await self.stop()
            raise
        self._caught_up = True

    async def _pump(self) -> None:
        while not self._stopped:
            try:
                await self._pump_once(self._view, self._fetch_positions)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                # transport failure: the broker may have restarted with a
                # fresh (shorter) log whose high watermark can even equal
                # our stale position — undetectable at the fetch level.
                # Rebuild into a SHADOW view and swap atomically when
                # caught up: the live view keeps serving reads meanwhile
                # (read-your-writes across transient drops), and ghosts
                # of a restarted broker's lost world vanish at the swap.
                logger.warning(
                    "kafka-wire table %s: transport error; rebuilding the "
                    "view from the log start", self._topic, exc_info=True,
                )
                await asyncio.sleep(0.5)
                await self._rebuild()
                continue
            self._advanced.set()

    async def _rebuild(self) -> None:
        try:
            meta = await self._client.metadata([self._topic])
            parts = meta["topics"].get(self._topic, {}).get("partitions", [])
            ends = await self._client.list_offsets(
                [(self._topic, p) for p in parts]
            )
            shadow: dict[str, bytes] = {}
            positions = {p: 0 for p in parts}
            while not self._stopped and any(
                positions[p] < ends.get((self._topic, p), 0) for p in parts
            ):
                await self._pump_once(shadow, positions)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — broker (still) down; the outer
            return  # loop fails its next fetch and retries the rebuild
        self._view = shadow
        self._fetch_positions = positions
        self._version += 1  # the whole view may have changed: one bump
        self._advanced.set()

    async def _pump_once(
        self, view: "dict[str, bytes]", positions: "dict[int, int]"
    ) -> None:
        """One fetch round applied to (view, positions); per-partition
        errors handled here, transport errors propagate to the caller."""
        wants = [
            (self._topic, part, off) for part, off in positions.items()
        ]
        if not wants:
            await asyncio.sleep(0.2)
            return
        results = await self._client.fetch(
            wants, max_wait_ms=300, max_bytes=self._fetch_max_bytes
        )
        for _topic, part, err, blob in results:
            if err == ERR_OFFSET_OUT_OF_RANGE:
                fresh = await self._client.list_offsets(
                    [(self._topic, part)], earliest=True
                )
                positions[part] = fresh.get((self._topic, part), 0)
                continue
            if err or not blob:
                continue
            try:
                batches = await _decode_off_loop(blob)
            except RecordBatchError:
                # poison batch: keep the pump task ALIVE (a dead pump
                # would turn start() timeouts opaque and freeze the
                # view silently after catch-up) and keep it loud
                logger.exception(
                    "kafka-wire table %s[%d]: undecodable RecordBatch; "
                    "view stalled at offset %s",
                    self._topic, part, positions.get(part),
                )
                await asyncio.sleep(1.0)
                continue
            for off, _ts, key, value, _headers in batches:
                if off < positions.get(part, 0):
                    continue
                text_key = (key or b"").decode("utf-8", errors="replace")
                if text_key:
                    if value:
                        view[text_key] = value
                    else:
                        view.pop(text_key, None)
                    if view is self._view:
                        # shadow rebuilds bump once at the swap instead
                        self._version += 1
                positions[part] = off + 1

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._task = None
        if self._client is not None:
            await self._client.close()
            self._client = None
        if self in self._mesh._readers:
            self._mesh._readers.remove(self)

    async def barrier(self, *, timeout: float = 30.0) -> None:
        if self._client is None:
            raise RuntimeError("table reader not started")
        wants = [(self._topic, part) for part in self._fetch_positions]
        if not wants:
            return
        ends = await self._client.list_offsets(wants)

        def behind() -> bool:
            return any(
                self._fetch_positions.get(part, 0) < off
                for (_t, part), off in ends.items()
                if off > 0
            )

        async def gate() -> None:
            while behind():
                self._advanced.clear()
                if not behind():
                    return
                await self._advanced.wait()

        await asyncio.wait_for(gate(), timeout=timeout)

    def get(self, key: str) -> bytes | None:
        return self._view.get(key)

    def items(self) -> dict[str, bytes]:
        return dict(self._view)

    @property
    def is_caught_up(self) -> bool:
        return self._caught_up

    @property
    def version(self) -> "int | None":
        return self._version


class _WireTableWriter(TableWriter):
    def __init__(self, mesh: KafkaWireMesh, topic: str):
        self._mesh = mesh
        self._topic = topic

    async def put(self, key: str, value: bytes) -> None:
        await self._mesh.publish(self._topic, value, key=key.encode("utf-8"))

    async def tombstone(self, key: str) -> None:
        await self._mesh.publish(self._topic, None, key=key.encode("utf-8"))
