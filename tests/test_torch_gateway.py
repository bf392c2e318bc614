"""The port's FileSystem SDK and S3 gateway (juicefs_tpu_torch/fs,
juicefs_tpu_torch/gateway) over hermetic backends, against the JAX
package's.

First the cases of tests/test_fs_gateway.py (fs SDK and S3) and the S3
cases of tests/test_gateway_plane.py (streaming GET, ingest/dedup PUTs,
multipart with a duplicate part, admission 503, SigV4 tenancy and a lying
payload hash, pagination, copy) run on the port; the port has no WebDAV
adapter and no fault-injecting store yet, so those cases stay with the JAX
package's suite. Then one seeded request sequence goes to the JAX
package's S3Gateway and to the port's, and the statuses, ETags, bodies
and listings must be equal; the `gateway` subcommand's volume store, with
a cpu BlockIndexer, writes the same digest rows as the JAX package's; and
the subcommand runs as a process that serves signed requests and /metrics
and exits 0 on SIGTERM. Gateway tests drive real HTTP against a loopback
server. A device hash backend with no card makes the gateway fail to
start.
"""

import hashlib
import http.client
import os
import threading
import urllib.parse
import xml.etree.ElementTree as ET

import pytest

from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig, ContentRefs, IngestPipeline
from juicefs_tpu_torch.fs import FSError, FileSystem
from juicefs_tpu_torch.gateway import S3Gateway
from juicefs_tpu_torch.gateway.serve import UNSATISFIABLE, parse_range
from juicefs_tpu_torch.meta import Format, new_client
from juicefs_tpu_torch.object import create_storage
from juicefs_tpu_torch.vfs import VFS


@pytest.fixture
def fs(tmp_path):
    m = new_client("mem://")
    m.init(Format(name="fstest", storage="mem", block_size=256), force=False)
    m.new_session()
    store = CachedStore(
        create_storage("mem://"),
        ChunkConfig(block_size=256 << 10, cache_dirs=(str(tmp_path / "c"),)),
    )
    v = VFS(m, store)
    yield FileSystem(v)
    v.close()


# ---------------------------------------------------------------- fs SDK --

def test_fs_roundtrip(fs):
    fs.makedirs("/a/b")
    fs.write_file("/a/b/f.txt", b"content")
    assert fs.read_file("/a/b/f.txt") == b"content"
    assert fs.stat("/a/b/f.txt").length == 7
    assert [e.name for e in fs.listdir("/a/b")] == [b"f.txt"]
    fs.rename("/a/b/f.txt", "/a/g.txt")
    assert fs.exists("/a/g.txt") and not fs.exists("/a/b/f.txt")
    fs.unlink("/a/g.txt")
    assert not fs.exists("/a/g.txt")


def test_fs_seek_tell_pread(fs):
    fs.write_file("/s.bin", b"0123456789")
    with fs.open("/s.bin") as f:
        assert f.read(3) == b"012"
        assert f.tell() == 3
        f.seek(-2, os.SEEK_END)
        assert f.read() == b"89"
        assert f.pread(4, 2) == b"45"


def test_fs_append_and_truncate(fs):
    with fs.create("/log") as f:
        f.write(b"one")
    with fs.open("/log", os.O_WRONLY | os.O_APPEND) as f:
        f.write(b"two")
    assert fs.read_file("/log") == b"onetwo"
    fs.truncate("/log", 3)
    assert fs.read_file("/log") == b"one"


def test_fs_symlink(fs):
    fs.write_file("/target", b"t")
    fs.symlink("/target", "/link")
    assert fs.readlink("/link") == "/target"
    assert fs.read_file("/link") == b"t"


def test_fs_errors(fs):
    with pytest.raises(FSError) as e:
        fs.read_file("/missing")
    assert e.value.errno == 2
    fs.mkdir("/d")
    with pytest.raises(FSError):
        fs.open("/d")  # EISDIR
    fs.write_file("/d/x", b"1")
    with pytest.raises(FSError):
        fs.rmdir("/d")  # ENOTEMPTY
    assert fs.remove_all("/d") >= 1


def test_fs_remove_all_and_summary(fs):
    fs.makedirs("/tree/sub")
    for i in range(5):
        fs.write_file(f"/tree/sub/f{i}", b"x" * 100)
    s = fs.summary("/tree")
    assert s.files == 5
    fs.remove_all("/tree")
    assert not fs.exists("/tree")


# ------------------------------------------------------------ S3 gateway --

@pytest.fixture
def s3(fs):
    from juicefs_tpu_torch.gateway import S3Gateway

    gw = S3Gateway(fs, port=0)
    port = gw.start()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    yield conn
    conn.close()
    gw.stop()


def _req(conn, method, path, body=None, headers=None):
    conn.request(method, path, body=body, headers=headers or {})
    r = conn.getresponse()
    return r.status, dict(r.getheaders()), r.read()


def test_s3_bucket_lifecycle(s3):
    st, _, _ = _req(s3, "PUT", "/mybucket")
    assert st == 200
    st, _, body = _req(s3, "GET", "/")
    assert st == 200 and b"mybucket" in body
    st, _, _ = _req(s3, "HEAD", "/mybucket")
    assert st == 200
    st, _, _ = _req(s3, "DELETE", "/mybucket")
    assert st == 204
    st, _, body = _req(s3, "GET", "/")
    assert b"mybucket" not in body


def test_s3_object_crud(s3):
    _req(s3, "PUT", "/b")
    st, hdrs, _ = _req(s3, "PUT", "/b/hello.txt", body=b"hello s3",
                       headers={"Content-Length": "8"})
    assert st == 200 and hdrs.get("ETag")
    st, hdrs, body = _req(s3, "GET", "/b/hello.txt")
    assert st == 200 and body == b"hello s3"
    st, hdrs, _ = _req(s3, "HEAD", "/b/hello.txt")
    assert st == 200 and hdrs["Content-Length"] == "8"
    # ranged read
    st, hdrs, body = _req(s3, "GET", "/b/hello.txt", headers={"Range": "bytes=6-7"})
    assert st == 206 and body == b"s3"
    # copy
    st, _, body = _req(s3, "PUT", "/b/copy.txt",
                       headers={"x-amz-copy-source": "/b/hello.txt"})
    assert st == 200 and b"CopyObjectResult" in body
    st, _, body = _req(s3, "GET", "/b/copy.txt")
    assert body == b"hello s3"
    st, _, _ = _req(s3, "DELETE", "/b/hello.txt")
    assert st == 204
    st, _, _ = _req(s3, "GET", "/b/hello.txt")
    assert st == 404
    # idempotent delete
    st, _, _ = _req(s3, "DELETE", "/b/hello.txt")
    assert st == 204


def test_s3_nested_keys_and_listing(s3):
    _req(s3, "PUT", "/b")
    for key in ("x/1.txt", "x/2.txt", "x/y/3.txt", "top.txt"):
        _req(s3, "PUT", f"/b/{key}", body=b"d", headers={"Content-Length": "1"})
    st, _, body = _req(s3, "GET", "/b?list-type=2&prefix=x/")
    root = ET.fromstring(body)
    ns = {"s3": "http://s3.amazonaws.com/doc/2006-03-01/"}
    keys = [el.text for el in root.findall(".//s3:Contents/s3:Key", ns)]
    assert set(keys) >= {"x/1.txt", "x/2.txt", "x/y/3.txt"}
    # delimiter: common prefixes
    st, _, body = _req(s3, "GET", "/b?list-type=2&prefix=x/&delimiter=/")
    root = ET.fromstring(body)
    keys = [el.text for el in root.findall(".//s3:Contents/s3:Key", ns)]
    prefixes = [el.text for el in root.findall(".//s3:CommonPrefixes/s3:Prefix", ns)]
    assert "x/y/" in prefixes and "x/y/3.txt" not in keys


def test_s3_multipart(s3):
    _req(s3, "PUT", "/b")
    st, _, body = _req(s3, "POST", "/b/mp.bin?uploads")
    upload_id = ET.fromstring(body).findtext(
        ".//{http://s3.amazonaws.com/doc/2006-03-01/}UploadId"
    )
    assert upload_id
    p1, p2 = os.urandom(300_000), os.urandom(100_000)
    for num, part in ((1, p1), (2, p2)):
        st, hdrs, _ = _req(
            s3, "PUT",
            f"/b/mp.bin?partNumber={num}&uploadId={upload_id}",
            body=part, headers={"Content-Length": str(len(part))},
        )
        assert st == 200
    st, _, body = _req(s3, "POST", f"/b/mp.bin?uploadId={upload_id}",
                       body=b"<CompleteMultipartUpload/>",
                       headers={"Content-Length": "26"})
    assert st == 200 and b"CompleteMultipartUploadResult" in body
    st, hdrs, body = _req(s3, "GET", "/b/mp.bin")
    assert body == p1 + p2


def test_s3_path_escape_denied(s3):
    _req(s3, "PUT", "/b")
    st, _, _ = _req(s3, "PUT", "/b/" + urllib.parse.quote("../escape"),
                    body=b"x", headers={"Content-Length": "1"})
    assert st in (403, 500)


def test_s3_upload_id_traversal_denied(s3):
    """A forged uploadId must never reach the multipart path join
    (advisor: '../../<bucket>' abort deleted a non-empty bucket)."""
    _req(s3, "PUT", "/b")
    st, _, _ = _req(s3, "PUT", "/b/keep.txt", body=b"data",
                    headers={"Content-Length": "4"})
    assert st == 200
    evil = urllib.parse.quote("../../b", safe="")
    st, _, body = _req(s3, "DELETE", f"/b/mp.bin?uploadId={evil}")
    assert st == 404 and b"NoSuchUpload" in body
    # the bucket and its object survived
    st, _, _ = _req(s3, "HEAD", "/b/keep.txt")
    assert st == 200
    # forged ids can't write outside the multipart area either
    st, _, _ = _req(s3, "PUT", f"/b/mp.bin?partNumber=1&uploadId={evil}",
                    body=b"x", headers={"Content-Length": "1"})
    assert st == 404
    # and complete with a forged id is rejected
    st, _, _ = _req(s3, "POST", f"/b/mp.bin?uploadId={evil}",
                    body=b"<CompleteMultipartUpload/>",
                    headers={"Content-Length": "26"})
    assert st == 404




def test_fs_relative_symlink_and_eloop(fs):
    fs.makedirs("/dir")
    fs.write_file("/dir/a", b"rel")
    fs.symlink("a", "/dir/b")  # relative: resolves against /dir
    assert fs.read_file("/dir/b") == b"rel"
    fs.symlink("/cyc2", "/cyc1")
    fs.symlink("/cyc1", "/cyc2")
    with pytest.raises(FSError) as e:
        fs.stat("/cyc1")
    assert e.value.errno == 40  # ELOOP


def test_fs_close_raises_on_flush_failure(fs, monkeypatch):
    f = fs.create("/doomed")
    f.write(b"bytes")
    monkeypatch.setattr(
        fs.vfs.store.storage, "put",
        lambda *a, **k: (_ for _ in ()).throw(IOError("down")),
    )
    monkeypatch.setattr(fs.vfs.store.conf, "max_retries", 1)
    with pytest.raises(FSError):
        f.close()


def test_s3_edge_cases(s3):
    _req(s3, "PUT", "/b")
    _req(s3, "PUT", "/b/k1", body=b"x", headers={"Content-Length": "1"})
    # max-keys=0: empty result, not truncated (matches real S3), no crash
    st, _, body = _req(s3, "GET", "/b?list-type=2&max-keys=0")
    assert st == 200 and b"<KeyCount>0</KeyCount>" in body
    assert b"<IsTruncated>false</IsTruncated>" in body
    # non-numeric max-keys -> 400, connection stays alive
    st, _, body = _req(s3, "GET", "/b?list-type=2&max-keys=abc")
    assert st == 400 and b"InvalidArgument" in body
    # Range starting past EOF -> 416 with the total length
    st, hdrs, _ = _req(s3, "GET", "/b/k1", headers={"Range": "bytes=10-"})
    assert st == 416 and hdrs["Content-Range"] == "bytes */1"
    # malformed Range falls back to a full 200 response
    st, _, body = _req(s3, "GET", "/b/k1", headers={"Range": "bytes=abc-"})
    assert st == 200 and body == b"x"
    # copy-source traversal is denied
    st, _, _ = _req(s3, "PUT", "/b/stolen",
                    headers={"x-amz-copy-source": "/b/../.sys/anything"})
    assert st in (403, 404, 500)


# ======================================================================
# the S3 cases of the gateway serving plane

BS = 1 << 18  # 256 KiB blocks keep the drills fast
NS = {"s3": "http://s3.amazonaws.com/doc/2006-03-01/"}


class CountingStore:
    """Backend wrapper recording data-path calls (counter-assertions)."""

    def __init__(self, inner):
        self._inner = inner
        self.put_keys: list[str] = []
        self.get_keys: list[str] = []
        self.deleted: list[str] = []
        self.lock = threading.Lock()

    def put(self, key, data):
        with self.lock:
            self.put_keys.append(key)
        return self._inner.put(key, data)

    def get(self, key, off=0, limit=-1):
        with self.lock:
            self.get_keys.append(key)
        return self._inner.get(key, off, limit)

    def delete(self, key):
        with self.lock:
            self.deleted.append(key)
        return self._inner.delete(key)

    def data_puts(self):
        with self.lock:
            return [k for k in self.put_keys if k.startswith("chunks/")]

    def data_gets(self):
        with self.lock:
            return [k for k in self.get_keys if k.startswith("chunks/")]

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _mkvol(with_ingest=False, **chunk_kw):
    m = new_client("mem://")
    m.init(Format(name="gwtest", storage="mem", block_size=BS >> 10),
           force=False)
    m.new_session()
    counting = CountingStore(create_storage("mem://"))
    store = CachedStore(counting, ChunkConfig(block_size=BS, **chunk_kw))
    if with_ingest:
        refs = ContentRefs(m)
        store.content_refs = refs
        store.ingest = IngestPipeline(store, refs, backend="cpu",
                                      batch_blocks=8, flush_timeout=0.005)
    v = VFS(m, store)
    return FileSystem(v), v, m, store, counting


@pytest.fixture
def plane_vol(tmp_path):
    fs, v, m, store, counting = _mkvol()
    yield fs, v, store, counting
    v.close()
    store.close()


@pytest.fixture
def s3_plane(plane_vol):
    fs, v, store, counting = plane_vol
    gw = S3Gateway(fs, port=0)
    port = gw.start()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    yield conn, gw, fs, store, counting
    conn.close()
    gw.stop()


# ------------------------------------------------------- range semantics --

def test_parse_range_semantics():
    """The ONE shared Range parser (satellite): suffix / inverted /
    multi-range / unsatisfiable semantics defined once for S3 + WebDAV."""
    # plain and clamped
    assert parse_range("bytes=0-9", 100) == (0, 9)
    assert parse_range("bytes=90-150", 100) == (90, 99)
    assert parse_range("bytes=10-", 100) == (10, 99)
    # a single-byte range is VALID, not inverted (mutation survivor:
    # the inverted check must be strict <)
    assert parse_range("bytes=5-5", 100) == (5, 5)
    # suffix
    assert parse_range("bytes=-10", 100) == (90, 99)
    assert parse_range("bytes=-500", 100) == (0, 99)
    # unsatisfiable
    assert parse_range("bytes=100-", 100) is UNSATISFIABLE
    assert parse_range("bytes=200-300", 100) is UNSATISFIABLE
    assert parse_range("bytes=-0", 100) is UNSATISFIABLE
    assert parse_range("bytes=0-", 0) is UNSATISFIABLE
    assert parse_range("bytes=-5", 0) is UNSATISFIABLE
    # ignored (full 200): absent, non-bytes, multi-range, inverted,
    # malformed, negative, suffix with junk
    assert parse_range(None, 100) is None
    assert parse_range("", 100) is None
    assert parse_range("items=0-1", 100) is None
    assert parse_range("bytes=0-1,3-4", 100) is None
    assert parse_range("bytes=9-3", 100) is None
    assert parse_range("bytes=abc-", 100) is None
    assert parse_range("bytes=-abc", 100) is None
    assert parse_range("bytes=--5", 100) is None
    assert parse_range("bytes=5", 100) is None


# ---------------------------------------------------------- streaming GET --

def test_get_streams_with_bounded_buffer(s3_plane):
    conn, gw, fs, store, counting = s3_plane
    body = b"".join(bytes([i % 251]) * BS for i in range(8))  # 8 blocks
    _req(conn, "PUT", "/b")
    st, hdrs, _ = _req(conn, "PUT", "/b/big.bin", body=body)
    assert st == 200
    gw.plane.buffered_peak = 0  # measure the GET only
    st, hdrs, got = _req(conn, "GET", "/b/big.bin")
    assert st == 200 and got == body
    assert int(hdrs["Content-Length"]) == len(body)
    # the acceptance counter: an object 8x the block size streamed
    # through a buffer that never exceeded one span
    assert 0 < gw.plane.buffered_peak <= gw.plane.span, \
        (gw.plane.buffered_peak, gw.plane.span)
    # ranges ride the same streaming path
    st, hdrs, got = _req(conn, "GET", "/b/big.bin",
                         headers={"Range": f"bytes={BS - 7}-{BS + 9}"})
    assert st == 206 and got == body[BS - 7:BS + 10]
    assert hdrs["Content-Range"] == f"bytes {BS - 7}-{BS + 9}/{len(body)}"
    st, _, got = _req(conn, "GET", "/b/big.bin",
                      headers={"Range": "bytes=-13"})
    assert st == 206 and got == body[-13:]
    st, hdrs, _ = _req(conn, "GET", "/b/big.bin",
                       headers={"Range": f"bytes={len(body)}-"})
    assert st == 416 and hdrs["Content-Range"] == f"bytes */{len(body)}"
    # multi-range is ignored: full representation (RFC 7233 allows it)
    st, _, got = _req(conn, "GET", "/b/big.bin",
                      headers={"Range": "bytes=0-1,5-6"})
    assert st == 200 and got == body
    # a range spanning SEVERAL streaming spans stops exactly at its end
    # (mutation survivor: the remaining-length arithmetic after the
    # first span must not over-stream past the requested range)
    start, end = 100, 100 + 2 * BS + BS // 2
    st, hdrs, got = _req(conn, "GET", "/b/big.bin",
                         headers={"Range": f"bytes={start}-{end}"})
    assert st == 206 and got == body[start:end + 1]
    assert int(hdrs["Content-Length"]) == end - start + 1


def test_put_etag_matches_seed_formula_for_small_objects(s3_plane):
    conn, gw, fs, store, counting = s3_plane
    from juicefs_tpu_torch import native
    from juicefs_tpu_torch.gpu.jth256 import digest_hex

    _req(conn, "PUT", "/b")
    body = b"etag me"
    st, hdrs, _ = _req(conn, "PUT", "/b/small", body=body)
    assert st == 200
    assert hdrs["ETag"] == f'"{digest_hex(native.jth256(body))[:32]}"'


# --------------------------------------------------- ingest/dedup write path

@pytest.fixture
def s3_dedup(tmp_path):
    fs, v, m, store, counting = _mkvol(with_ingest=True)
    gw = S3Gateway(fs, port=0)
    port = gw.start()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    yield conn, gw, fs, store, counting
    conn.close()
    gw.stop()
    v.close()
    store.close()


def test_duplicate_put_elides_backend_puts(s3_dedup):
    """PUT bodies ride the ingest plane: a second object with identical
    content causes ZERO new data PUTs (the acceptance counter)."""
    conn, gw, fs, store, counting = s3_dedup
    content = bytes([7]) * BS + bytes([9]) * BS  # two distinct blocks
    _req(conn, "PUT", "/b")
    st, _, _ = _req(conn, "PUT", "/b/one.bin", body=content)
    assert st == 200
    store.ingest.flush(5.0)  # registrations land before the dup arrives
    before = len(counting.data_puts())
    assert before == 2
    st, _, _ = _req(conn, "PUT", "/b/two.bin", body=content)
    assert st == 200
    store.ingest.flush(5.0)
    assert len(counting.data_puts()) == before, \
        "duplicate-content PUT reached the backend"
    for key in ("/b/one.bin", "/b/two.bin"):
        st, _, got = _req(conn, "GET", key)
        assert st == 200 and got == content


def test_multipart_parts_dedup_and_meta_only_complete(s3_dedup):
    """Parts stream through the ingest plane (dup part content elides its
    PUTs) and CompleteMultipartUpload is a pure metadata stitch: zero
    object-store reads or writes while completing."""
    conn, gw, fs, store, counting = s3_dedup
    _req(conn, "PUT", "/b")
    st, _, body = _req(conn, "POST", "/b/mp.bin?uploads")
    upload_id = ET.fromstring(body).findtext(".//s3:UploadId", namespaces=NS)
    p1 = bytes([1]) * BS + bytes([2]) * BS  # 2 blocks
    p2 = bytes([3]) * (BS + 1024)           # block + tail
    p3 = p1                                 # duplicate content of part 1
    for num, part in ((1, p1), (2, p2)):
        st, _, _ = _req(conn, "PUT",
                        f"/b/mp.bin?partNumber={num}&uploadId={upload_id}",
                        body=part)
        assert st == 200
    store.ingest.flush(5.0)
    before_dup = len(counting.data_puts())
    st, _, _ = _req(conn, "PUT",
                    f"/b/mp.bin?partNumber=3&uploadId={upload_id}",
                    body=p3)
    assert st == 200
    store.ingest.flush(5.0)
    # part 3's two full blocks elided; only its (empty) tail could add
    assert len(counting.data_puts()) == before_dup, \
        "duplicate part content reached the backend"
    puts0, gets0 = len(counting.put_keys), len(counting.get_keys)
    st, _, body = _req(conn, "POST", f"/b/mp.bin?uploadId={upload_id}",
                       body=b"<CompleteMultipartUpload/>")
    assert st == 200 and b"CompleteMultipartUploadResult" in body
    assert len(counting.put_keys) == puts0, "complete re-uploaded parts"
    assert len(counting.get_keys) == gets0, "complete re-read parts"
    st, _, got = _req(conn, "GET", "/b/mp.bin")
    assert st == 200 and got == p1 + p2 + p3


# ------------------------------------------------------------- admission --

class _BlockingStore:
    """GETs park on an event: deterministic in-flight occupancy."""

    def __init__(self, inner):
        self._inner = inner
        self.release = threading.Event()

    def get(self, key, off=0, limit=-1):
        self.release.wait(10.0)
        return self._inner.get(key, off, limit)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_overload_sheds_503_slowdown_never_500(tmp_path):
    m = new_client("mem://")
    m.init(Format(name="gwshed", storage="mem", block_size=BS >> 10),
           force=False)
    m.new_session()
    blocking = _BlockingStore(create_storage("mem://"))
    store = CachedStore(blocking, ChunkConfig(block_size=BS, cache_size=1,
                                              hedge=False))
    v = VFS(m, store)
    fs = FileSystem(v)
    fs.mkdir("/b")
    blocking.release.set()
    fs.write_file("/b/slow.bin", b"z" * (BS // 2))
    gw = S3Gateway(fs, port=0, max_inflight=2)
    port = gw.start()
    try:
        blocking.release.clear()  # cold GETs will now park in-flight
        results = []
        res_lock = threading.Lock()

        def one_get():
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=15)
            try:
                st, _, body = _req(c, "GET", "/b/slow.bin")
                with res_lock:
                    results.append((st, body))
            finally:
                c.close()

        # two requests occupy the whole gate...
        parked = [threading.Thread(target=one_get) for _ in range(2)]
        for t in parked:
            t.start()
        deadline = threading.Event()
        for _ in range(100):
            if gw.plane.gate.inflight >= 2:
                break
            deadline.wait(0.05)
        assert gw.plane.gate.inflight >= 2
        # ...so every further arrival sheds immediately as SlowDown
        shed = [threading.Thread(target=one_get) for _ in range(4)]
        for t in shed:
            t.start()
        for t in shed:
            t.join()
        with res_lock:
            assert len(results) == 4
            assert all(st == 503 for st, _ in results), results
            assert all(b"SlowDown" in body for _, body in results)
        assert gw.plane.gate.shed == 4
        blocking.release.set()  # the admitted pair completes normally
        for t in parked:
            t.join()
        with res_lock:
            codes = sorted(st for st, _ in results)
        assert codes == [200, 200, 503, 503, 503, 503]
        assert not any(c >= 500 and c != 503 for c in codes), codes
        snap = gw.plane.stats()
        assert snap["admission"]["shed"] == 4
        # the server-side leave() may lag the client's final read a tick
        for _ in range(100):
            if gw.plane.gate.inflight == 0:
                break
            deadline.wait(0.02)
        assert gw.plane.gate.inflight == 0
    finally:
        blocking.release.set()
        gw.stop()
        v.close()
        store.close()


# ---------------------------------------------------------------- tenancy --

def _signed(signer, method, host, path, body=b"", query=None,
            payload_hash=None):
    ph = payload_hash or "UNSIGNED-PAYLOAD"
    return signer.sign(method, host, path, query or {}, ph)


def test_sigv4_multi_key_tenants(tmp_path):
    from juicefs_tpu_torch.object.s3 import SigV4

    fs, v, m, store, counting = _mkvol()
    gw = S3Gateway(fs, port=0,
                   tenant_keys={"AKALICE": "alicesecret",
                                "AKBOB": "bobsecret"})
    port = gw.start()
    host = f"127.0.0.1:{port}"
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        alice = SigV4("AKALICE", "alicesecret")
        bob = SigV4("AKBOB", "bobsecret")
        st, _, _ = _req(conn, "PUT", "/b",
                        headers=_signed(alice, "PUT", host, "/b"))
        assert st == 200
        # signed-payload PUT: the streamed body must match its sha
        body = b"alice's bytes" * 100
        sha = hashlib.sha256(body).hexdigest()
        st, _, _ = _req(conn, "PUT", "/b/a.txt", body=body,
                        headers=_signed(alice, "PUT", host, "/b/a.txt",
                                        payload_hash=sha))
        assert st == 200
        # a LYING payload hash is caught while streaming and unwound
        st, _, resp = _req(conn, "PUT", "/b/liar.txt", body=b"not the hash",
                           headers=_signed(bob, "PUT", host, "/b/liar.txt",
                                           payload_hash=sha))
        assert st == 400 and b"XAmzContentSHA256Mismatch" in resp
        st, _, _ = _req(conn, "HEAD", "/b/liar.txt",
                        headers=_signed(bob, "HEAD", host, "/b/liar.txt"))
        assert st == 404  # the partial object did not survive
        # ...and a lying OVERWRITE leaves the existing object intact:
        # the stream lands in a temp key and only publishes on success
        st, _, resp = _req(conn, "PUT", "/b/a.txt", body=b"evil overwrite",
                           headers=_signed(bob, "PUT", host, "/b/a.txt",
                                           payload_hash=sha))
        assert st == 400
        st, _, got = _req(conn, "GET", "/b/a.txt",
                          headers=_signed(alice, "GET", host, "/b/a.txt"))
        assert st == 200 and got == body, "failed overwrite destroyed object"
        # bob reads alice's object (shared namespace, distinct tenant)
        st, _, got = _req(conn, "GET", "/b/a.txt",
                          headers=_signed(bob, "GET", host, "/b/a.txt"))
        assert st == 200 and got == body
        # wrong secret -> 403, counted
        evil = SigV4("AKBOB", "wrongsecret")
        st, _, resp = _req(conn, "GET", "/b/a.txt",
                           headers=_signed(evil, "GET", host, "/b/a.txt"))
        assert st == 403 and b"SignatureDoesNotMatch" in resp
        # unknown access key -> 403
        ghost = SigV4("AKGHOST", "whatever")
        st, _, _ = _req(conn, "GET", "/b/a.txt",
                        headers=_signed(ghost, "GET", host, "/b/a.txt"))
        assert st == 403
        # unsigned request against an authed gateway -> 403
        st, _, _ = _req(conn, "GET", "/b/a.txt")
        assert st == 403
        # UNSIGNED-PAYLOAD on an OBJECT PUT streams without a hash check
        # (mutation survivor: the unsigned/empty-sha short-circuit)
        st, _, _ = _req(conn, "PUT", "/b/unsigned.bin", body=b"no hash",
                        headers=_signed(alice, "PUT", host,
                                        "/b/unsigned.bin"))
        assert st == 200
        st, _, got = _req(conn, "GET", "/b/unsigned.bin",
                          headers=_signed(alice, "GET", host,
                                          "/b/unsigned.bin"))
        assert st == 200 and got == b"no hash"
        # the aws-chunked streaming scheme is rejected exactly 501
        hdrs = _signed(alice, "PUT", host, "/b/chunked.bin")
        hdrs["x-amz-content-sha256"] = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
        st, _, resp = _req(conn, "PUT", "/b/chunked.bin", body=b"x",
                           headers=hdrs)
        assert st == 501 and b"NotImplemented" in resp
        # the buffered multipart manifest is hash-checked too (mutation
        # survivor: the mismatch must answer exactly 400)
        st, _, body = _req(conn, "POST", "/b/mp.bin?uploads",
                           headers=_signed(alice, "POST", host, "/b/mp.bin",
                                           query={"uploads": ""}))
        assert st == 200, body
        upload_id = ET.fromstring(body).findtext(".//s3:UploadId",
                                                 namespaces=NS)
        part = b"part-one"
        q = {"partNumber": "1", "uploadId": upload_id}
        st, _, _ = _req(
            conn, "PUT", f"/b/mp.bin?partNumber=1&uploadId={upload_id}",
            body=part,
            headers=_signed(alice, "PUT", host, "/b/mp.bin", query=q,
                            payload_hash=hashlib.sha256(part).hexdigest()))
        assert st == 200
        manifest = b"<CompleteMultipartUpload/>"
        lying = hashlib.sha256(b"other manifest").hexdigest()
        st, _, resp = _req(
            conn, "POST", f"/b/mp.bin?uploadId={upload_id}", body=manifest,
            headers=_signed(alice, "POST", host, "/b/mp.bin",
                            query={"uploadId": upload_id},
                            payload_hash=lying))
        assert st == 400 and b"XAmzContentSHA256Mismatch" in resp
        st, _, _ = _req(
            conn, "POST", f"/b/mp.bin?uploadId={upload_id}", body=manifest,
            headers=_signed(alice, "POST", host, "/b/mp.bin",
                            query={"uploadId": upload_id},
                            payload_hash=hashlib.sha256(
                                manifest).hexdigest()))
        assert st == 200
        st, _, got = _req(conn, "GET", "/b/mp.bin",
                          headers=_signed(bob, "GET", host, "/b/mp.bin"))
        assert st == 200 and got == part
        # per-tenant attribution: both principals appear with their ops,
        # under DISTINCT tenant uids
        snap = gw.plane.stats()
        assert snap["tenants"]["AKALICE"] >= 2
        assert snap["tenants"]["AKBOB"] >= 2
        uids = {t.uid for t in gw.plane._tenants.values()}
        assert len(uids) == len(gw.plane._tenants)
    finally:
        conn.close()
        gw.stop()
        v.close()
        store.close()


# ----------------------------------------------------------------- listing --

def _list_page(conn, bucket, **params):
    q = urllib.parse.urlencode({"list-type": "2", **params})
    st, _, body = _req(conn, "GET", f"/{bucket}?{q}")
    assert st == 200, body
    root = ET.fromstring(body)
    keys = [el.text for el in root.findall(".//s3:Contents/s3:Key", NS)]
    prefixes = [el.text for el in
                root.findall(".//s3:CommonPrefixes/s3:Prefix", NS)]
    token = root.findtext(".//s3:NextContinuationToken", namespaces=NS)
    truncated = root.findtext(".//s3:IsTruncated", namespaces=NS) == "true"
    return keys, prefixes, token, truncated


def _paginate(conn, bucket, **params):
    keys, prefixes = [], []
    token = None
    for _ in range(100):
        page = dict(params)
        if token:
            page["continuation-token"] = token
        k, p, token, truncated = _list_page(conn, bucket, **page)
        keys += k
        prefixes += p
        if not truncated:
            return keys, prefixes
    raise AssertionError("pagination never terminated")


def test_list_v2_pagination_ordered_and_complete(s3_plane):
    conn, gw, fs, store, counting = s3_plane
    _req(conn, "PUT", "/b")
    expect = []
    # ordering stressor: "foo.txt" sorts BEFORE directory foo's subtree
    # ('.' 0x2e < '/' 0x2f) even though a bare name sort says otherwise
    for key in ["foo/1.txt", "foo/2.txt", "foo.txt", "foo.txt.bak",
                "foo0", "top.txt", "a/x/deep.bin", "a/y.bin", "z.bin"] \
            + [f"d{d}/f{i:02d}" for d in range(3) for i in range(8)]:
        st, _, _ = _req(conn, "PUT", f"/b/{key}", body=b"1")
        assert st == 200
        expect.append(key)
    expect.sort()
    # one page >= bucket: everything, in S3 key order
    keys, prefixes, token, truncated = _list_page(conn, "b")
    assert keys == expect and not truncated and not prefixes
    # small pages: the union is exact, ordered, duplicate-free
    for page in (1, 3, 7):
        keys, prefixes = _paginate(conn, "b", **{"max-keys": str(page)})
        assert keys == expect, f"page={page}"
        assert not prefixes
    # prefix + pagination
    keys, _ = _paginate(conn, "b", prefix="d1/", **{"max-keys": "3"})
    assert keys == [f"d1/f{i:02d}" for i in range(8)]
    # delimiter roll-up with pagination: prefixes count toward the page
    keys, prefixes = _paginate(conn, "b", delimiter="/",
                               **{"max-keys": "2"})
    assert keys == ["foo.txt", "foo.txt.bak", "foo0", "top.txt", "z.bin"]
    assert prefixes == ["a/", "d0/", "d1/", "d2/", "foo/"]
    # one un-paginated delimiter page: KeyCount covers keys AND prefixes
    q = urllib.parse.urlencode({"list-type": "2", "delimiter": "/"})
    st, _, raw = _req(conn, "GET", f"/b?{q}")
    assert f"<KeyCount>{len(keys) + len(prefixes)}</KeyCount>".encode() in raw
    # prefix WITHOUT a trailing slash + delimiter: the delimiter at
    # position 0 of the remainder still rolls up (mutation survivor:
    # the cut >= 0 boundary)
    keys, prefixes = _paginate(conn, "b", prefix="foo", delimiter="/")
    assert keys == ["foo.txt", "foo.txt.bak", "foo0"]
    assert prefixes == ["foo/"]
    # start-after resumes mid-stream (exclusive)
    keys, _ = _paginate(conn, "b", **{"start-after": "foo.txt",
                                      "max-keys": "5"})
    assert keys == [k for k in expect if k > "foo.txt"]


def test_list_dotted_keys_but_never_the_multipart_area(s3_plane):
    """Dotted names are ordinary S3 keys (real-S3 semantics); the
    multipart staging area is a VOLUME-root sibling of the buckets, so
    an in-progress upload never surfaces in any bucket listing."""
    conn, gw, fs, store, counting = s3_plane
    _req(conn, "PUT", "/b")
    st, _, _ = _req(conn, "PUT", "/b/.topdot", body=b"x")
    assert st == 200
    st, _, _ = _req(conn, "PUT", "/b/d/.hidden", body=b"x")
    assert st == 200
    # an in-progress multipart upload (part already staged under /.sys)
    st, _, body = _req(conn, "POST", "/b/mp.bin?uploads")
    assert st == 200
    upload_id = ET.fromstring(body).findtext(".//s3:UploadId",
                                             namespaces=NS)
    st, _, _ = _req(conn, "PUT",
                    f"/b/mp.bin?partNumber=1&uploadId={upload_id}",
                    body=b"p" * 100)
    assert st == 200
    keys, prefixes, _tok, _tr = _list_page(conn, "b")
    assert keys == [".topdot", "d/.hidden"], keys
    # and the staged part is invisible to ListBuckets too
    st, _, body = _req(conn, "GET", "/")
    assert b".sys" not in body


def test_list_page_reads_bounded_directories(s3_plane):
    """A page never walks directories beyond what it emits: the
    incremental walk is the no-full-bucket-recursion guarantee."""
    conn, gw, fs, store, counting = s3_plane
    _req(conn, "PUT", "/b")
    for d in range(4):
        for i in range(25):
            st, _, _ = _req(conn, "PUT", f"/b/dir{d}/f{i:03d}", body=b"x")
            assert st == 200
    calls = []
    orig = FileSystem.listdir

    def spy(self, path, want_attr=False):
        calls.append(path)
        return orig(self, path, want_attr)

    FileSystem.listdir = spy
    try:
        keys, _, token, truncated = _list_page(conn, "b",
                                               **{"max-keys": "10"})
    finally:
        FileSystem.listdir = orig
    assert truncated and len(keys) == 10
    # the page fits inside dir0: only the bucket root and dir0 were read
    listed = [p for p in calls if p.startswith("/b")]
    assert sorted(set(listed)) == ["/b", "/b/dir0/"], listed


def _counter_value(name, *labels):
    from juicefs_tpu_torch.metric import global_registry

    m = global_registry()._metrics[name]
    return (m.labels(*labels) if labels else m).value


def test_dir_marker_put_and_copy_into_new_dirs(s3_plane):
    conn, gw, fs, store, counting = s3_plane
    _req(conn, "PUT", "/b")
    # a trailing-slash key with an empty body is a directory marker: 200
    st, hdrs, _ = _req(conn, "PUT", "/b/marker/")
    assert st == 200 and hdrs.get("ETag")
    # server-side copy into a destination whose parent dirs don't exist
    st, _, _ = _req(conn, "PUT", "/b/flat.bin", body=b"m" * 100)
    assert st == 200
    st, _, resp = _req(conn, "PUT", "/b/new/deep/dst.bin",
                       headers={"x-amz-copy-source": "/b/flat.bin"})
    assert st == 200 and b"CopyObjectResult" in resp
    st, _, got = _req(conn, "GET", "/b/new/deep/dst.bin")
    assert st == 200 and got == b"m" * 100
    # a failed copy (missing source) into a fresh prefix leaves NO empty
    # dir tree behind: the bucket still deletes once its keys are gone
    st, _, _ = _req(conn, "PUT", "/b/ghost/sub/x.bin",
                    headers={"x-amz-copy-source": "/b/missing.bin"})
    assert st == 404
    assert not fs.exists("/b/ghost"), \
        "failed copy stranded an empty dir tree (would 409 DeleteBucket)"


def test_delete_nonempty_bucket_409(s3_plane):
    conn, gw, fs, store, counting = s3_plane
    _req(conn, "PUT", "/b")
    st, _, _ = _req(conn, "PUT", "/b/keep", body=b"x")
    assert st == 200
    st, _, body = _req(conn, "DELETE", "/b")
    assert st == 409 and b"BucketNotEmpty" in body
    st, _, _ = _req(conn, "HEAD", "/b/keep")
    assert st == 200


def test_error_families_counted_from_400_up(s3_plane):
    """The errors counter includes the 4xx BOUNDARY (a 400 is an error
    response — mutation survivor: the threshold must be >= 400) and
    splits families correctly."""
    conn, gw, fs, store, counting = s3_plane
    _req(conn, "PUT", "/b")
    c4 = _counter_value("juicefs_gateway_errors", "4xx")
    c5 = _counter_value("juicefs_gateway_errors", "5xx")
    st, _, _ = _req(conn, "GET", "/b?list-type=2&max-keys=abc")  # exactly 400
    assert st == 400
    st, _, _ = _req(conn, "GET", "/b/nope")  # 404
    assert st == 404
    assert _counter_value("juicefs_gateway_errors", "4xx") == c4 + 2
    assert _counter_value("juicefs_gateway_errors", "5xx") == c5


# ------------------------------------------------------------ chaos drill --



# ----------------------------------------------------------------- webdav --







# --------------------------------------------------------- s3 server copy --

def test_s3_copy_object_is_server_side(s3_plane):
    conn, gw, fs, store, counting = s3_plane
    _req(conn, "PUT", "/b")
    body = b"c" * (2 * BS + 100)
    st, _, _ = _req(conn, "PUT", "/b/src.bin", body=body)
    assert st == 200
    puts0, gets0 = len(counting.put_keys), len(counting.get_keys)
    st, _, resp = _req(conn, "PUT", "/b/dst.bin",
                       headers={"x-amz-copy-source": "/b/src.bin"})
    assert st == 200 and b"CopyObjectResult" in resp
    assert len(counting.put_keys) == puts0, "copy re-uploaded data"
    assert len(counting.get_keys) == gets0, "copy re-read data"
    st, _, got = _req(conn, "GET", "/b/dst.bin")
    assert st == 200 and got == body
    # copy-to-SELF is an S3 metadata refresh: the source must survive
    # (a naive create-then-copy truncates it to nothing)
    st, _, resp = _req(conn, "PUT", "/b/src.bin",
                       headers={"x-amz-copy-source": "/b/src.bin"})
    assert st == 200 and b"CopyObjectResult" in resp
    st, _, got = _req(conn, "GET", "/b/src.bin")
    assert st == 200 and got == body


# ======================================================================
# the port against the JAX package

import datetime  # noqa: E402
import re  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from juicefs_tpu import cmd as ref_cmd  # noqa: E402
from juicefs_tpu.chunk import CachedStore as RefCachedStore  # noqa: E402
from juicefs_tpu.chunk import ChunkConfig as RefChunkConfig  # noqa: E402
from juicefs_tpu.cmd import gateway as ref_cmd_gateway  # noqa: E402
from juicefs_tpu.fs import FileSystem as RefFileSystem  # noqa: E402
from juicefs_tpu.gateway import S3Gateway as RefS3Gateway  # noqa: E402
from juicefs_tpu.meta import Format as RefFormat  # noqa: E402
from juicefs_tpu.meta import new_client as ref_new_client  # noqa: E402
from juicefs_tpu.object import create_storage as ref_create_storage  # noqa: E402
from juicefs_tpu.object.s3 import SigV4 as RefSigV4  # noqa: E402
from juicefs_tpu.vfs import VFS as RefVFS  # noqa: E402
from juicefs_tpu_torch import cmd as port_cmd  # noqa: E402
from juicefs_tpu_torch.cmd import gateway as port_cmd_gateway  # noqa: E402
from juicefs_tpu_torch.gpu.jth256 import digest_hex, jth256  # noqa: E402
from juicefs_tpu_torch.object.s3 import SigV4  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AK, SK = "AKPARITY", "parity-secret"


def test_sigv4_signs_like_the_reference():
    now = datetime.datetime(2026, 1, 2, 3, 4, 5, tzinfo=datetime.timezone.utc)
    args = ("PUT", "h:1", "/b/k ey", {"partNumber": "2", "uploadId": "u/1"},
            hashlib.sha256(b"x").hexdigest())
    extra = {"x-amz-copy-source": "/b/src", "Content-Type": "a/b"}
    got = SigV4(AK, SK).sign(*args, extra_headers=extra, now=now)
    assert got == RefSigV4(AK, SK).sign(*args, extra_headers=extra, now=now)
    lower = {k.lower(): v for k, v in got.items()}
    lower["host"] = "h:1"
    assert SigV4(AK, SK).verify("PUT", "/b/k ey", args[3], lower, got["Authorization"])
    assert not SigV4(AK, "other").verify("PUT", "/b/k ey", args[3], lower,
                                         got["Authorization"])


class _Client:
    """A signed S3 client of one gateway; every call returns what the
    parity check compares."""

    def __init__(self, port: int, signer):
        self.host = f"127.0.0.1:{port}"
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        self.signer = signer

    def call(self, method, path, body=b"", query=None, headers=None, sign=True,
             payload_hash=None):
        query = query or {}
        headers = dict(headers or {})
        if sign:
            ph = payload_hash or hashlib.sha256(body).hexdigest()
            headers.update(self.signer.sign(method, self.host, path, query, ph,
                                            extra_headers=headers))
        url = urllib.parse.quote(path) + ("?" + urllib.parse.urlencode(query) if query else "")
        self.conn.request(method, url, body=body or None, headers=headers)
        r = self.conn.getresponse()
        data = r.read()
        return r.status, dict(r.getheaders()), data

    def close(self):
        self.conn.close()


def _list_all(client, bucket, page):
    keys, tokens, token = [], [], None
    while True:
        q = {"list-type": "2", "max-keys": str(page)}
        if token:
            q["continuation-token"] = token
        st, _, body = client.call("GET", f"/{bucket}", query=q)
        assert st == 200, body
        root = ET.fromstring(body)
        keys += [el.text for el in root.findall(".//s3:Contents/s3:Key", NS)]
        token = root.findtext(".//s3:NextContinuationToken", namespaces=NS)
        tokens.append(token)
        if root.findtext(".//s3:IsTruncated", namespaces=NS) != "true":
            return keys, tokens


def _sequence(client, seed: int) -> list:
    """One seeded S3 session: objects of ragged sizes (several spans,
    duplicate content), reads, ranges, copy, multipart with a repeated
    part, paginated listing, deletes and refused requests. Returns what
    each request observed: status, ETag, body where it is data."""
    rng = np.random.default_rng(seed)
    out = []

    def note(tag, st, hdrs, body=None):
        out.append((tag, st, hdrs.get("ETag"), body))

    note("mkbucket", *client.call("PUT", "/bkt")[:2])
    pool = [rng.bytes(BS) for _ in range(2)]
    objects = {}
    for i in range(10):
        n = int(rng.choice([0, 7, BS - 1, BS, 2 * BS + 5, 3 * BS + BS // 2]))
        body = (pool[i % 2] * 4)[:n] if rng.random() < 0.3 else rng.bytes(n)
        key = f"{['a', 'b/c', 'b', 'd/e/f'][i % 4]}/obj{i:02d}.bin"
        objects[key] = body
        st, hdrs, _ = client.call("PUT", f"/bkt/{key}", body=body)
        note("put " + key, st, hdrs)
    for key, body in objects.items():
        st, hdrs, got = client.call("GET", f"/bkt/{key}")
        note("get " + key, st, hdrs, got)
        note("head " + key, *client.call("HEAD", f"/bkt/{key}")[:2])
        if body:
            a = int(rng.integers(0, len(body)))
            b = int(rng.integers(a, len(body)))
            st, hdrs, got = client.call("GET", f"/bkt/{key}",
                                        headers={"Range": f"bytes={a}-{b}"})
            note(f"range {key} {a}-{b}", st, {"ETag": hdrs.get("Content-Range")}, got)
    src = next(k for k, b in objects.items() if len(b) > BS)
    st, hdrs, _ = client.call("PUT", "/bkt/copy/of.bin", headers={"x-amz-copy-source": f"/bkt/{src}"})
    note("copy", st, hdrs)
    st, hdrs, got = client.call("GET", "/bkt/copy/of.bin")
    note("get copy", st, hdrs, got == objects[src])
    # multipart: part 3 repeats part 1
    st, _, body = client.call("POST", "/bkt/mp.bin", query={"uploads": ""})
    upload = ET.fromstring(body).findtext(".//s3:UploadId", namespaces=NS)
    parts = [rng.bytes(BS + 11), rng.bytes(BS // 3)]
    parts.append(parts[0])
    for num, part in enumerate(parts, 1):
        st, hdrs, _ = client.call("PUT", "/bkt/mp.bin", body=part,
                                  query={"partNumber": str(num), "uploadId": upload})
        note(f"part {num}", st, hdrs)
    st, hdrs, body = client.call("POST", "/bkt/mp.bin", body=b"<CompleteMultipartUpload/>",
                                 query={"uploadId": upload})
    note("complete", st, {"ETag": ET.fromstring(body).findtext(".//s3:ETag", namespaces=NS)})
    st, hdrs, got = client.call("GET", "/bkt/mp.bin")
    note("get mp", st, hdrs, got == b"".join(parts))
    for page in (3, 7, 1000):
        out.append(("list", page) + tuple(map(tuple, _list_all(client, "bkt", page))))
    # refused: unsigned, a lying payload hash (its object must not exist)
    note("unsigned", *client.call("GET", "/bkt/a/obj00.bin", sign=False)[:2])
    liar = hashlib.sha256(b"something else").hexdigest()
    note("liar", *client.call("PUT", "/bkt/liar.bin", body=b"x" * 1000, payload_hash=liar)[:2])
    note("head liar", *client.call("HEAD", "/bkt/liar.bin")[:2])
    for key in list(objects)[:4]:
        note("delete " + key, *client.call("DELETE", f"/bkt/{key}")[:2])
        note("gone " + key, *client.call("GET", f"/bkt/{key}")[:2])
    note("rmbucket", *client.call("DELETE", "/bkt")[:2])
    out.append(("final list",) + tuple(map(tuple, _list_all(client, "bkt", 4))))
    return out


def _mem_volume(pkg):
    """(FileSystem, VFS, store) of one package over mem meta + mem store."""
    new_client_, format_, store_, conf_, storage_, vfs_, fs_ = pkg
    m = new_client_("mem://")
    m.init(format_(name="gwparity", storage="mem", block_size=BS >> 10), force=False)
    m.new_session()
    store = store_(storage_("mem://"), conf_(block_size=BS, cache_dirs=("memory",)))
    v = vfs_(m, store)
    return fs_(v), v, store


REF_PKG = (ref_new_client, RefFormat, RefCachedStore, RefChunkConfig, ref_create_storage,
           RefVFS, RefFileSystem)
PORT_PKG = (new_client, Format, CachedStore, ChunkConfig, create_storage, VFS, FileSystem)


@pytest.mark.parametrize("seed", [4, 5])
def test_request_sequence_matches_reference_gateway(seed):
    """The same seeded request sequence to the JAX package's S3Gateway and
    to the port's: statuses, ETags, bodies and listings are equal."""
    seen = {}
    for side, pkg, gw_cls, signer in (("ref", REF_PKG, RefS3Gateway, RefSigV4(AK, SK)),
                                      ("port", PORT_PKG, S3Gateway, SigV4(AK, SK))):
        fs, v, store = _mem_volume(pkg)
        gw = gw_cls(fs, port=0, access_key=AK, secret_key=SK)
        client = _Client(gw.start(), signer)
        try:
            seen[side] = _sequence(client, seed)
        finally:
            client.close()
            gw.stop()
            v.close()
            store.close()
    assert len(seen["port"]) == len(seen["ref"])
    for want, got in zip(seen["ref"], seen["port"]):
        assert got == want, f"{want[0]}: port {str(got)[:200]} != reference {str(want)[:200]}"
    statuses = {s[1] for s in seen["port"] if isinstance(s[1], int)}
    assert {200, 206, 403, 400, 404, 409} <= statuses  # 409: rmbucket of a non-empty one


def _gateway_args(meta_url, tmp_path, side, **kw):
    return types.SimpleNamespace(
        meta_url=meta_url, address="127.0.0.1", port=0, metrics="",
        cache_dir=str(tmp_path / f"{side}-cache"), cache_size=0, writeback=False,
        compress_backend="cpu", access_key=AK, secret_key=SK, tenant_key=["AKT:tsecret"],
        max_inflight=64, **kw)


def _format_both(tmp_path, compress="lz4", hash_backend="cpu"):
    urls = {}
    for side, main in (("port", port_cmd.main), ("ref", ref_cmd.main)):
        urls[side] = f"sqlite3://{tmp_path}/{side}.db"
        assert main(["format", urls[side], "gw", "--storage", "file", "--bucket",
                     str(tmp_path / f"{side}-blob"), "--block-size", str(BS >> 10),
                     "--compress", compress, "--hash-backend", hash_backend,
                     "--trash-days", "0"]) == 0
    return urls


def test_gateway_indexer_rows_match_reference(tmp_path):
    """The `gateway` subcommand's store on a cpu-backend volume: after the
    same PUTs (one multipart part repeating another), the port's
    BlockIndexer wrote the same digest rows as the JAX package's, and
    every row is the spec's digest of its block."""
    urls = _format_both(tmp_path)
    rng = np.random.default_rng(9)
    bodies = {f"k{i}": rng.bytes(n) for i, n in enumerate((7, BS, 3 * BS + 9, 2 * BS))}
    rows = {}
    for side in ("ref", "port"):
        args = _gateway_args(urls[side], tmp_path, side)
        if side == "port":
            gw, v, m = port_cmd_gateway.start_gateway(args)
            signer = SigV4(AK, SK)
        else:
            fs, v, m = ref_cmd_gateway._build_fs(args)
            gw = RefS3Gateway(fs, port=0, access_key=AK, secret_key=SK,
                              tenant_keys={"AKT": "tsecret"})
            gw.start()
            signer = RefSigV4(AK, SK)
        client = _Client(gw.port, signer)
        try:
            assert client.call("PUT", "/bkt")[0] == 200
            for key, body in bodies.items():
                assert client.call("PUT", f"/bkt/{key}", body=body)[0] == 200
            tenant = _Client(gw.port, (SigV4 if side == "port" else RefSigV4)("AKT", "tsecret"))
            st, _, got = tenant.call("GET", "/bkt/k2")
            tenant.close()
            assert st == 200 and got == bodies["k2"]
        finally:
            client.close()
            gw.stop()
            v.close()
            v.store.close()  # drains the indexer
            rows[side] = sorted(m.scan_block_digests())
            m.close_session()
            m.client.close()
    assert rows["port"] == rows["ref"]
    blocks = [b[i:i + BS] for b in bodies.values() for i in range(0, len(b), BS)]
    assert len(rows["port"]) == len(blocks)
    assert sorted(d for *_k, d in rows["port"]) == sorted(jth256(b) for b in blocks)


@pytest.mark.parametrize("volume", ["pallas", "lz4-cuda-plane"])
def test_gateway_on_a_device_volume_without_card_raises(tmp_path, volume):
    """A device hash backend, or a compressed volume whose compress plane
    runs on the card (the default), needs a card: the gateway fails to
    start, nothing falls back to the CPU, and the session is closed."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    meta_url = f"sqlite3://{tmp_path}/dev.db"
    if volume == "pallas":
        assert ref_cmd.main(["format", meta_url, "dev", "--storage", "file", "--bucket",
                             str(tmp_path / "blob"), "--compress", "none",
                             "--hash-backend", "pallas"]) == 0
        args = _gateway_args(meta_url, tmp_path, "port")
    else:
        assert port_cmd.main(["format", meta_url, "dev", "--storage", "file", "--bucket",
                              str(tmp_path / "blob"), "--compress", "lz4",
                              "--hash-backend", "cpu"]) == 0
        args = _gateway_args(meta_url, tmp_path, "port")
        args.compress_backend = "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cmd_gateway.start_gateway(args)
    m = new_client(meta_url)
    try:
        assert m.do_list_sessions() == []
    finally:
        m.client.close()
    assert port_cmd.main(["gateway", meta_url, "--port", "0"]) == 1


def _read_line(proc, pattern, deadline):
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        m = re.search(pattern, line)
        if m:
            return m
    raise AssertionError(f"no line matching {pattern!r} from the gateway")


def test_gateway_subcommand_serves_and_exits_on_sigterm(tmp_path):
    """`python -m juicefs_tpu_torch.cmd gateway` as a process: a signed PUT
    and GET, the juicefs_gateway_* counters on /metrics, exit 0 on
    SIGTERM."""
    meta_url = f"sqlite3://{tmp_path}/cli.db"
    assert port_cmd.main(["format", meta_url, "cli", "--storage", "file", "--bucket",
                          str(tmp_path / "blob"), "--block-size", str(BS >> 10),
                          "--compress", "lz4", "--hash-backend", "cpu"]) == 0
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "juicefs_tpu_torch.cmd", "gateway", meta_url, "--port", "0",
         "--access-key", AK, "--secret-key", SK, "--metrics", "127.0.0.1:0",
         "--compress-backend", "cpu", "--cache-dir", str(tmp_path / "cache")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        metrics_port = int(_read_line(proc, r"metrics on http://[^:]+:(\d+)/", deadline)[1])
        port = int(_read_line(proc, r"S3 gateway listening on port (\d+)", deadline)[1])
        client = _Client(port, SigV4(AK, SK))
        body = np.random.default_rng(3).bytes(BS + 5)
        assert client.call("PUT", "/bkt")[0] == 200
        st, hdrs, _ = client.call("PUT", "/bkt/obj", body=body)
        assert st == 200
        assert hdrs["ETag"].strip('"') == digest_hex(jth256(hashlib.sha256(
            jth256(body[:BS]) + jth256(body[BS:])).digest()))[:32]
        st, _, got = client.call("GET", "/bkt/obj")
        assert st == 200 and got == body
        assert client.call("GET", "/bkt/obj", sign=False)[0] == 403
        client.close()
        mconn = http.client.HTTPConnection("127.0.0.1", metrics_port, timeout=30)
        mconn.request("GET", "/metrics")
        text = mconn.getresponse().read().decode()
        mconn.close()
        puts = re.search(r'juicefs_gateway_requests\{op="put"\} (\S+)', text)
        assert puts and float(puts[1]) >= 2, text[:2000]
        assert "juicefs_gateway_auth_failures" in text
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.stdout.close()
    assert rc == 0
