"""The port's S3 and WebDAV object clients (juicefs_tpu_torch/object/s3.py
S3Storage, object/webdav.py WebDAVStorage) over real HTTP, against the JAX
package's.

First the cases of tests/test_object.py that drive the S3 driver (multipart
and copy, a bad secret, tamper and replay, the objbench functional suite,
the registry, unsigned-payload interop) and the object battery over the
`s3` and `webdav` stores run on the port, against the port's own S3
gateway and WebDAV server. Then the wire is crossed both ways: the port's
clients talk to the JAX package's servers and the JAX package's clients to
the port's, and one seeded session of operations must observe the same
bytes, sizes, listings, multipart ETags and error classes in all four
pairings. Each package keeps its own storage objects: a resilience layer
recognises only its own package's NotFoundError.
"""

import datetime
import hashlib
import http.client

import numpy as np
import pytest

from juicefs_tpu.chunk import CachedStore as RefCachedStore
from juicefs_tpu.chunk import ChunkConfig as RefChunkConfig
from juicefs_tpu.fs import FileSystem as RefFileSystem
from juicefs_tpu.gateway import S3Gateway as RefS3Gateway
from juicefs_tpu.gateway.webdav import WebDAVServer as RefWebDAVServer
from juicefs_tpu.meta import Format as RefFormat
from juicefs_tpu.meta import new_client as ref_new_client
from juicefs_tpu.object import create_storage as ref_create_storage
from juicefs_tpu.object.s3 import S3Storage as RefS3Storage
from juicefs_tpu.vfs import VFS as RefVFS
from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig
from juicefs_tpu_torch.cmd.objbench import functional
from juicefs_tpu_torch.fs import FileSystem
from juicefs_tpu_torch.gateway import S3Gateway
from juicefs_tpu_torch.gateway.webdav import WebDAVServer
from juicefs_tpu_torch.meta import Format, new_client
from juicefs_tpu_torch.object import NotFoundError, create_storage
from juicefs_tpu_torch.object.s3 import _EMPTY_SHA256, S3Storage, SigV4
from juicefs_tpu_torch.object.webdav import WebDAVStorage
from juicefs_tpu_torch.vfs import VFS

AK, SK = "testak", "testsk"


def _server_stack(pkg: str, tmp_path, kind: str):
    """A mem-meta volume of one package served by that package's S3
    gateway (SigV4 enforced) or WebDAV server. Returns (server, vfs, fs,
    endpoint URI without the bucket or base)."""
    if pkg == "port":
        mk = (new_client, Format, CachedStore, ChunkConfig, create_storage, VFS,
              FileSystem, S3Gateway, WebDAVServer)
    else:
        mk = (ref_new_client, RefFormat, RefCachedStore, RefChunkConfig, ref_create_storage,
              RefVFS, RefFileSystem, RefS3Gateway, RefWebDAVServer)
    new_client_, format_, store_, conf_, storage_, vfs_, fs_, s3_, dav_ = mk
    m = new_client_("mem://")
    m.init(format_(name=f"{kind}t", storage="mem", block_size=256), force=False)
    m.new_session()
    cs = store_(storage_("mem://"),
                conf_(block_size=256 << 10, cache_dirs=(str(tmp_path / f"{pkg}-{kind}"),)))
    v = vfs_(m, cs)
    fs = fs_(v)
    if kind == "s3":
        srv = s3_(fs, port=0, access_key=AK, secret_key=SK)
        return srv, v, fs, f"s3://{AK}:{SK}@127.0.0.1:{srv.start()}"
    srv = dav_(fs, port=0)
    return srv, v, fs, f"webdav://127.0.0.1:{srv.start()}"


def _close(s) -> None:
    """S3Storage pools its connections; WebDAVStorage keeps one per thread
    and has no close()."""
    if isinstance(s, (S3Storage, RefS3Storage)):
        s.close()


@pytest.fixture
def s3_env(tmp_path):
    srv, v, fs, ep = _server_stack("port", tmp_path, "s3")
    yield ep
    srv.stop()
    v.close()
    v.store.close()


@pytest.fixture(params=["s3", "webdav"])
def store(request, tmp_path):
    srv, v, fs, ep = _server_stack("port", tmp_path, request.param)
    s = create_storage(ep + ("/bkt" if request.param == "s3" else "/vol"))
    s.create()
    yield s
    _close(s)
    srv.stop()
    v.close()
    v.store.close()


# ------------------------------------------------------------- battery --

def test_put_get_delete(store):
    store.put("k1", b"hello world")
    assert store.get("k1") == b"hello world"
    assert store.head("k1").size == 11
    store.delete("k1")
    with pytest.raises(NotFoundError):
        store.get("k1")
    with pytest.raises(NotFoundError):
        store.head("k1")
    store.delete("k1")  # idempotent


def test_ranged_get(store):
    store.put("r", bytes(range(100)))
    assert store.get("r", 10, 5) == bytes(range(10, 15))
    assert store.get("r", 90) == bytes(range(90, 100))
    assert store.get("r", 0, -1) == bytes(range(100))


def test_overwrite(store):
    store.put("o", b"v1")
    store.put("o", b"v2-longer")
    assert store.get("o") == b"v2-longer"


def test_list_all_ordered(store):
    keys = [f"chunks/{i}/{j}/blk" for i in range(3) for j in range(3)]
    for i, k in enumerate(keys):
        store.put(k, b"x" * i)
    listed = [o.key for o in store.list_all("chunks/")]
    assert listed == sorted(keys)
    after = [o.key for o in store.list_all("chunks/", marker=listed[4])]
    assert after == sorted(keys)[5:]
    assert [o.key for o in store.list_all("chunks/1/")] == \
        sorted(k for k in keys if k.startswith("chunks/1/"))


def test_empty_object(store):
    store.put("empty", b"")
    assert store.get("empty") == b""
    assert store.head("empty").size == 0


def test_objbench_functional(store):
    assert functional(store) == []


# ------------------------------------------------------ the S3 driver --

def test_s3_driver_multipart_and_copy(s3_env):
    s = create_storage(s3_env + "/bkt")
    assert isinstance(s, S3Storage)
    s.create()
    up = s.create_multipart_upload("big")
    assert up and up.upload_id
    parts = [s.upload_part("big", up.upload_id, n, bytes([n]) * 200_000) for n in (1, 2, 3)]
    s.complete_upload("big", up.upload_id, parts)
    assert s.get("big") == b"\x01" * 200_000 + b"\x02" * 200_000 + b"\x03" * 200_000
    up2 = s.create_multipart_upload("tmp")
    s.upload_part("tmp", up2.upload_id, 1, b"x" * 10)
    s.abort_upload("tmp", up2.upload_id)
    with pytest.raises(NotFoundError):
        s.head("tmp")
    s.put("a", b"copy me")
    s.copy("b", "a")
    assert s.get("b") == b"copy me"


def test_s3_sigv4_rejects_bad_secret(s3_env):
    good = create_storage(s3_env + "/bkt")
    good.create()
    good.put("k", b"v")
    host = s3_env.split("@", 1)[1]
    bad = create_storage(f"s3://{AK}:WRONG@{host}/bkt")
    with pytest.raises(IOError):
        bad.put("k2", b"v2")
    with pytest.raises(IOError):
        bad.get("k")
    assert good.get("k") == b"v"


def test_s3_sigv4_rejects_tamper_and_replay(s3_env):
    create_storage(s3_env + "/bkt").create()
    host = s3_env.split("@", 1)[1]
    signer = SigV4(AK, SK)
    conn = http.client.HTTPConnection(host, timeout=10)
    # signed for body "AAAA" but sent "EVIL": rejected
    hdrs = signer.sign("PUT", host, "/bkt/t1", {}, hashlib.sha256(b"AAAA").hexdigest())
    hdrs["Content-Length"] = "4"
    conn.request("PUT", "/bkt/t1", body=b"EVIL", headers=hdrs)
    r = conn.getresponse()
    assert r.status == 400 and b"SHA256Mismatch" in r.read()
    # correctly signed but dated an hour ago: rejected (replay)
    old = datetime.datetime.now(datetime.timezone.utc) - datetime.timedelta(hours=1)
    hdrs = signer.sign("GET", host, "/bkt", {"list-type": "2"}, _EMPTY_SHA256, now=old)
    conn.request("GET", "/bkt?list-type=2", headers=hdrs)
    r = conn.getresponse()
    assert r.status == 403 and b"RequestTimeTooSkewed" in r.read()
    conn.close()


def test_create_storage_registry(tmp_path):
    s = create_storage(f"file://{tmp_path}/reg")
    s.create()
    s.put("a", b"1")
    assert create_storage(f"file://{tmp_path}/reg").get("a") == b"1"
    with pytest.raises(ValueError):
        create_storage("s3gibberish://x")
    for uri, cls in (("s3://a:b@127.0.0.1:9/bkt/pre", S3Storage),
                     ("minio://127.0.0.1:9/bkt", S3Storage),
                     ("webdav://127.0.0.1:9/base", WebDAVStorage)):
        assert type(create_storage(uri)) is cls
    assert create_storage("s3://a:b@127.0.0.1:9/bkt/pre").prefix == "pre/"
    with pytest.raises(ValueError, match="bucket"):
        create_storage("s3://127.0.0.1:9")


def test_s3_sigv4_unsigned_payload_interop(s3_env):
    """UNSIGNED-PAYLOAD is accepted (the signature still covers the
    literal), a wrong secret is still refused, and the streaming scheme is
    an explicit 501."""
    create_storage(s3_env + "/bkt").create()
    host = s3_env.split("@", 1)[1]
    signer = SigV4(AK, SK)
    conn = http.client.HTTPConnection(host, timeout=10)
    body = b"sdk-style upload"
    hdrs = signer.sign("PUT", host, "/bkt/u1", {}, "UNSIGNED-PAYLOAD")
    hdrs["Content-Length"] = str(len(body))
    conn.request("PUT", "/bkt/u1", body=body, headers=hdrs)
    r = conn.getresponse()
    r.read()
    assert r.status in (200, 201), r.status
    assert bytes(create_storage(s3_env + "/bkt").get("u1")) == body
    hdrs = SigV4(AK, "WRONG").sign("PUT", host, "/bkt/u2", {}, "UNSIGNED-PAYLOAD")
    hdrs["Content-Length"] = "3"
    conn.request("PUT", "/bkt/u2", body=b"nop", headers=hdrs)
    r = conn.getresponse()
    r.read()
    assert r.status == 403
    hdrs = signer.sign("PUT", host, "/bkt/u3", {}, "STREAMING-AWS4-HMAC-SHA256-PAYLOAD")
    hdrs["Content-Length"] = "3"
    conn.request("PUT", "/bkt/u3", body=b"xyz", headers=hdrs)
    r = conn.getresponse()
    r.read()
    assert r.status == 501
    conn.close()


# ------------------------------------------------ crossing the wire --

def _session(create, uri: str, seed: int, multipart: bool) -> list:
    """One seeded sequence of object operations through one client.
    Returns what each observed: bytes, sizes, listings, part ETags, or the
    class name (and HTTP status) of the error it raised."""
    rng = np.random.default_rng(seed)
    out = []

    def rec(tag, fn):
        try:
            v = fn()
        except Exception as e:
            v = ("raise", type(e).__name__, getattr(e, "status", None))
        out.append((tag, v))
        return v

    s = create(uri)
    s.create()
    pool = [rng.bytes(300_000), rng.bytes(70_000)]
    objects = {}
    for i in range(9):
        n = int(rng.choice([0, 1, 1000, 300_000, 700_001]))
        body = (pool[i % 2] * 3)[:n] if rng.random() < 0.3 else rng.bytes(n)
        key = f"{['a', 'b/c', 'd/e/f'][i % 3]}/o{i}.bin"
        objects[key] = body
        rec("put " + key, lambda: s.put(key, body))
    for key, body in objects.items():
        rec("get " + key, lambda: bytes(s.get(key)))
        rec("head " + key, lambda: s.head(key).size)
        if body:
            off = int(rng.integers(0, len(body)))
            lim = int(rng.integers(-1, len(body) - off + 1))
            rec(f"range {key} {off} {lim}", lambda: bytes(s.get(key, off, lim)))
    rec("list", lambda: [(o.key, o.size, o.is_dir) for o in s.list_all()])
    rec("list b/", lambda: [o.key for o in s.list_all("b/")])
    marker = sorted(objects)[3]
    rec("list after", lambda: [o.key for o in s.list_all("", marker)])
    src = next(k for k, b in objects.items() if b)
    rec("copy", lambda: s.copy("copies/x.bin", src))
    rec("get copy", lambda: bytes(s.get("copies/x.bin")) == objects[src])
    if multipart:
        up = s.create_multipart_upload("mp.bin")
        parts = [rng.bytes(300_000 + 11), rng.bytes(100_000)]
        parts.append(parts[0])
        got = [s.upload_part("mp.bin", up.upload_id, n, p) for n, p in enumerate(parts, 1)]
        out.append(("parts", [(p.num, p.etag, p.size) for p in got]))
        rec("complete", lambda: s.complete_upload("mp.bin", up.upload_id, got))
        rec("get mp", lambda: bytes(s.get("mp.bin")) == b"".join(parts))
        up2 = s.create_multipart_upload("ab.bin")
        part = s.upload_part("ab.bin", up2.upload_id, 1, b"x" * 1024)
        rec("abort", lambda: s.abort_upload("ab.bin", up2.upload_id))
        rec("complete aborted", lambda: s.complete_upload("ab.bin", up2.upload_id, [part]))
        rec("head aborted", lambda: s.head("ab.bin").size)
    else:
        rec("no multipart", lambda: s.create_multipart_upload("mp.bin"))
    rec("get missing", lambda: s.get("nope/missing"))
    rec("head missing", lambda: s.head("nope/missing"))
    gone = list(objects)[:3]
    for key in gone:
        rec("delete " + key, lambda: s.delete(key))
        rec("gone " + key, lambda: s.get(key))
        rec("delete again " + key, lambda: s.delete(key))
    rec("final list", lambda: [(o.key, o.size) for o in s.list_all()])
    if uri.startswith("s3://"):
        host = uri.split("@", 1)[1]
        bad = create(f"s3://{AK}:WRONG@{host}")
        rec("bad put", lambda: bad.put("k2", b"v2"))
        rec("bad get", lambda: bad.get(list(objects)[-1]))
    _close(s)
    return out


def _many(fs, root: str, n: int) -> None:
    """n objects written server-side, so that a listing pages over the
    wire (the clients ask for 1000 keys a page)."""
    fs.makedirs(root)
    for i in range(n):
        fs.write_file(f"{root}/k{i:05d}", b"m" * (i % 7))


@pytest.mark.parametrize("kind", ["s3", "webdav"])
def test_clients_and_servers_cross_the_wire(tmp_path, kind):
    """The same seeded session through every (client, server) pairing of
    the two packages observes the same results."""
    clients = {"port": create_storage, "ref": ref_create_storage}
    seen = {}
    for server in ("ref", "port"):
        for client in ("ref", "port"):
            srv, v, fs, ep = _server_stack(server, tmp_path / f"{server}-{client}", kind)
            try:
                base = ep + ("/bkt" if kind == "s3" else "/vol")
                seen[(client, server)] = _session(clients[client], base, 17,
                                                  multipart=kind == "s3")
            finally:
                srv.stop()
                v.close()
                v.store.close()
    want = seen[("ref", "ref")]
    statuses = {v[2] for _, v in want if isinstance(v, tuple) and v[:1] == ("raise",)}
    names = {v[1] for _, v in want if isinstance(v, tuple) and v[:1] == ("raise",)}
    assert "NotFoundError" in names
    if kind == "s3":
        assert "PermanentError" in names and 403 in statuses
    for pair, got in seen.items():
        assert len(got) == len(want), pair
        for a, b in zip(want, got):
            assert b == a, f"{pair} {a[0]}: {str(b)[:200]} != reference {str(a)[:200]}"


def test_s3_listing_pages_across_the_wire(tmp_path):
    """ListObjectsV2 continuation tokens: 1003 keys list in order through
    the port's client from the reference's gateway and the other way
    round."""
    for server, create in (("ref", create_storage), ("port", ref_create_storage)):
        srv, v, fs, ep = _server_stack(server, tmp_path / server, "s3")
        try:
            s = create(ep + "/bkt")
            s.create()
            _many(fs, "/bkt/many", 1003)
            keys = [o.key for o in s.list_all("many/")]
            assert keys == [f"many/k{i:05d}" for i in range(1003)]
            assert [o.key for o in s.list_all("many/", "many/k00998")] == \
                [f"many/k{i:05d}" for i in range(999, 1003)]
            _close(s)
        finally:
            srv.stop()
            v.close()
            v.store.close()
