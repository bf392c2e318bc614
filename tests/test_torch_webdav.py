"""The port's WebDAV adapter (juicefs_tpu_torch/gateway/webdav.py and the
`webdav` subcommand of cmd/gateway.py) against the JAX package's.

One seeded DAV request sequence goes to both packages' WebDAVServer and
the statuses, bodies and PROPFIND listings must be equal. The `webdav`
subcommand's store on a cpu-backend volume writes the same digest rows as
the JAX package's after the same PUTs (each PUT goes through the volume's
FileSystem, so through its BlockIndexer). The subcommand runs as a process
that serves and exits 0 on SIGTERM, and on a device volume with no card it
fails to start. The server-side cases of the JAX package's WebDAV tests
are in tests/test_torch_gateway.py.
"""

import http.client
import os
import re
import signal
import subprocess
import sys
import time
import types
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from juicefs_tpu.cmd import gateway as ref_cmd_gateway
from juicefs_tpu.cmd import main as ref_main
from juicefs_tpu.gateway.webdav import WebDAVServer as RefWebDAVServer
from juicefs_tpu.tpu.jth256 import jth256
from juicefs_tpu_torch.cmd import gateway as port_cmd_gateway
from juicefs_tpu_torch.cmd import main
from juicefs_tpu_torch.gateway.webdav import WebDAVServer
from juicefs_tpu_torch.meta import new_client
from tests.test_torch_object_remote import _server_stack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 256 << 10


def _req(conn, method, path, body=None, headers=None):
    conn.request(method, path, body=body, headers=headers or {})
    r = conn.getresponse()
    return r.status, dict(r.getheaders()), r.read()


def _propfind(body: bytes) -> list:
    """(href, is collection, length) of every response, in order."""
    out = []
    for r in ET.fromstring(body).findall("{DAV:}response"):
        prop = r.find("{DAV:}propstat/{DAV:}prop")
        out.append((r.findtext("{DAV:}href"),
                    prop.find("{DAV:}resourcetype/{DAV:}collection") is not None,
                    prop.findtext("{DAV:}getcontentlength")))
    return out


def _sequence(conn, seed: int) -> list:
    """A seeded DAV session: collections, PUTs of ragged sizes, GETs,
    ranges, PROPFIND at depth 0 and 1, MOVE, COPY (with and without
    overwrite), DELETE, and refused requests."""
    rng = np.random.default_rng(seed)
    out = []

    def note(tag, st, hdrs, body=None):
        out.append((tag, st, hdrs.get("Content-Range"), hdrs.get("Content-Length"), body))

    for col in ("/a", "/a/b", "/c"):
        note("mkcol " + col, *_req(conn, "MKCOL", col)[:2])
    note("mkcol again", *_req(conn, "MKCOL", "/a")[:2])
    note("mkcol orphan", *_req(conn, "MKCOL", "/x/y")[:2])
    files = {}
    for i in range(8):
        n = int(rng.choice([0, 9, BS - 1, BS, 2 * BS + 3]))
        path = f"{['/a', '/a/b', '/c'][i % 3]}/f{i}.bin"
        files[path] = rng.bytes(n)
        note("put " + path, *_req(conn, "PUT", path, body=files[path])[:2])
    note("put orphan", *_req(conn, "PUT", "/nope/f", body=b"x")[:2])
    for path, body in files.items():
        st, hdrs, got = _req(conn, "GET", path)
        note("get " + path, st, hdrs, got)
        note("head " + path, *_req(conn, "HEAD", path)[:2])
        if body:
            a = int(rng.integers(0, len(body)))
            st, hdrs, got = _req(conn, "GET", path, headers={"Range": f"bytes={a}-"})
            note(f"range {path} {a}-", st, hdrs, got)
        st, hdrs, _ = _req(conn, "GET", path, headers={"Range": f"bytes={len(body)}-"})
        note(f"range past {path}", st, hdrs)
    for path, depth in (("/", "1"), ("/a", "1"), ("/a/b", "0"), ("/a/f0.bin", "0")):
        st, _, body = _req(conn, "PROPFIND", path, headers={"Depth": depth})
        out.append(("propfind " + path, st, _propfind(body)))
    note("propfind missing", *_req(conn, "PROPFIND", "/zz", headers={"Depth": "1"})[:2])
    first, second = list(files)[:2]
    note("move", *_req(conn, "MOVE", first, headers={"Destination": "http://h/c/moved"})[:2])
    note("get moved", *_req(conn, "GET", "/c/moved"))
    note("copy", *_req(conn, "COPY", second, headers={"Destination": "http://h/c/copied"})[:2])
    note("copy no overwrite", *_req(conn, "COPY", second, headers={
        "Destination": "http://h/c/copied", "Overwrite": "F"})[:2])
    note("copy dir", *_req(conn, "COPY", "/a/b", headers={"Destination": "http://h/z"})[:2])
    note("get copied", *_req(conn, "GET", "/c/copied"))
    note("delete", *_req(conn, "DELETE", "/a/b")[:2])
    note("delete missing", *_req(conn, "DELETE", "/a/b")[:2])
    note("get deleted", *_req(conn, "GET", list(files)[1])[:2])
    note("get dir", *_req(conn, "GET", "/a")[:2])
    st, _, body = _req(conn, "PROPFIND", "/", headers={"Depth": "1"})
    out.append(("final", st, _propfind(body)))
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_request_sequence_matches_reference_webdav(tmp_path, seed):
    seen = {}
    for side in ("ref", "port"):
        srv, v, fs, ep = _server_stack(side, tmp_path / side, "webdav")
        conn = http.client.HTTPConnection("127.0.0.1", int(ep.rsplit(":", 1)[1]), timeout=30)
        try:
            seen[side] = _sequence(conn, seed)
        finally:
            conn.close()
            srv.stop()
            v.close()
            v.store.close()
    assert len(seen["port"]) == len(seen["ref"])
    for want, got in zip(seen["ref"], seen["port"]):
        assert got == want, f"{want[0]}: port {str(got)[:200]} != reference {str(want)[:200]}"
    statuses = {s[1] for s in seen["port"]}
    assert {200, 201, 204, 206, 207, 403, 404, 405, 409, 412, 416} <= statuses


def _args(meta_url, tmp_path, side):
    return types.SimpleNamespace(meta_url=meta_url, address="127.0.0.1", port=0,
                                 cache_dir=str(tmp_path / f"{side}-cache"), cache_size=0,
                                 writeback=False, compress_backend="cpu")


def test_webdav_indexer_rows_match_reference(tmp_path):
    """The `webdav` subcommand's store on a cpu-backend lz4 volume: after
    the same PUTs (one repeating another's bytes) both packages wrote the
    same digest rows, each the spec's digest of its block."""
    rng = np.random.default_rng(5)
    bodies = {f"/k{i}": rng.bytes(n) for i, n in enumerate((7, BS, 3 * BS + 9, 2 * BS))}
    bodies["/dup"] = bodies["/k1"]
    rows = {}
    for side, entry in (("ref", ref_main), ("port", main)):
        meta_url = f"sqlite3://{tmp_path}/{side}.db"
        assert entry(["format", meta_url, "dav", "--storage", "file", "--bucket",
                      str(tmp_path / f"{side}-blob"), "--block-size", str(BS >> 10),
                      "--compress", "lz4", "--hash-backend", "cpu", "--trash-days", "0"]) == 0
        args = _args(meta_url, tmp_path, side)
        if side == "port":
            srv, v, m = port_cmd_gateway.start_webdav(args)
        else:
            fs, v, m = ref_cmd_gateway._build_fs(args)
            srv = RefWebDAVServer(fs, port=0)
            srv.start()
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        try:
            for path, body in bodies.items():
                assert _req(conn, "PUT", path, body=body)[0] == 201
                st, _, got = _req(conn, "GET", path)
                assert st == 200 and got == body
        finally:
            conn.close()
            srv.stop()
            v.close()
            v.store.close()  # drains the indexer
            rows[side] = sorted(m.scan_block_digests())
            m.close_session()
            m.client.close()
    assert rows["port"] == rows["ref"]
    blocks = [b[i:i + BS] for b in bodies.values() for i in range(0, len(b), BS)]
    assert sorted(d for *_k, d in rows["port"]) == sorted(jth256(b) for b in blocks)


def test_webdav_on_a_device_volume_without_card_raises(tmp_path):
    """A `pallas` volume needs the card: the server fails to start, the
    session is closed, and the subcommand exits 1."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    meta_url = f"sqlite3://{tmp_path}/dev.db"
    assert ref_main(["format", meta_url, "dev", "--storage", "file", "--bucket",
                     str(tmp_path / "blob"), "--compress", "none",
                     "--hash-backend", "pallas"]) == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cmd_gateway.start_webdav(_args(meta_url, tmp_path, "port"))
    m = new_client(meta_url)
    try:
        assert m.do_list_sessions() == []
    finally:
        m.client.close()
    assert main(["webdav", meta_url, "--port", "0"]) == 1


def test_webdav_subcommand_serves_and_exits_on_sigterm(tmp_path):
    """`python -m juicefs_tpu_torch.cmd webdav` as a process: PUT, GET and
    PROPFIND, the index batch on /metrics, then exit 0 on SIGTERM."""
    meta_url = f"sqlite3://{tmp_path}/cli.db"
    assert main(["format", meta_url, "cli", "--storage", "file", "--bucket",
                 str(tmp_path / "blob"), "--block-size", str(BS >> 10),
                 "--compress", "lz4", "--hash-backend", "cpu"]) == 0
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "juicefs_tpu_torch.cmd", "webdav", meta_url, "--port", "0",
         "--compress-backend", "cpu", "--cache-dir", str(tmp_path / "cache"),
         "--metrics", "127.0.0.1:0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        ports = {}
        while "dav" not in ports and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            m = re.search(r"metrics on http://[^:]+:(\d+)/|WebDAV listening on port (\d+)",
                          line)
            if m:
                ports["metrics" if m[1] else "dav"] = int(m[1] or m[2])
        assert sorted(ports) == ["dav", "metrics"], "the webdav process did not start"
        port = ports["dav"]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        body = np.random.default_rng(3).bytes(BS + 5)
        assert _req(conn, "MKCOL", "/d")[0] == 201
        assert _req(conn, "PUT", "/d/obj", body=body)[0] == 201
        st, _, got = _req(conn, "GET", "/d/obj")
        assert st == 200 and got == body
        st, _, listing = _req(conn, "PROPFIND", "/d", headers={"Depth": "1"})
        assert st == 207 and _propfind(listing)[1] == ("/d/obj", False, str(len(body)))
        conn.close()
        batches = 0
        while time.time() < deadline and batches == 0:
            mconn = http.client.HTTPConnection("127.0.0.1", ports["metrics"], timeout=30)
            mconn.request("GET", "/metrics")
            text = mconn.getresponse().read().decode()
            mconn.close()
            m = re.search(r'juicefs_torch_stage_seconds_count\{layer="gpu",op="index",'
                          r'stage="batch"\} (\S+)', text)
            batches = float(m[1]) if m else 0
            time.sleep(0.1)
        assert batches >= 1  # the PUT's blocks went to the volume's indexer
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.stdout.close()
    assert rc == 0
