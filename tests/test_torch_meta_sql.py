"""The port's relational meta engine (juicefs_tpu_torch/meta/sql.py,
`sql://`) against the JAX package's and against the port's kv engine.

  - The seeded random op drill of tests/test_meta_random.py replays on the
    port's sql://, the reference's sql:// and the port's kv engine
    (sqlite3://): every step's result (errnos included) and the final tree
    must be equal.
  - A sql:// file written by either package opens in the other with the
    same namespace, slices, digest rows, content refs, aliases and hot
    fingerprints.
  - The content-ref plane and the digest index give the same answers on
    the same call sequence.
  - `export_kv_records` of one file is the reference's record for record
    plus the content-ref plane (H/G records and the hotfp blob, byte for
    byte as the kv engine keys them), which the reference's export drops;
    a port dump loads back into either engine family of either package
    (the reference's sql import skips the plane, its kv import keeps it),
    and an inline-dedup volume's elided blocks read back after a dump ->
    load.

The port's sql closures run under the port's own rerun harness
(juicefs_tpu_torch/utils/txnwatch.py), installed for the whole module: each
successful closure runs twice (rolled back to a savepoint in between) and
any divergence fails the test.
"""

from __future__ import annotations

import os

import pytest

from juicefs_tpu.meta import dump as ref_dump
from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig, ContentRefs, IngestPipeline
from juicefs_tpu_torch.chunk.cached_store import block_key
from juicefs_tpu_torch.meta import dump as port_dump
from juicefs_tpu_torch.meta.sql import SQLMeta
from juicefs_tpu_torch.utils import txnwatch
from tests.test_torch_meta import PACKAGES, Driver, _populate, _volume, gen_ops


@pytest.fixture(scope="module", autouse=True)
def port_txnwatch():
    """Arm the port's rerun harness for this module (the suite's conftest
    arms only the reference's)."""
    assert txnwatch.enabled()
    txnwatch.install()
    try:
        yield txnwatch
    finally:
        txnwatch.uninstall()


@pytest.fixture(autouse=True)
def port_txnwatch_guard(port_txnwatch):
    before = len(txnwatch.violations())
    yield
    new = txnwatch.violations()[before:]
    assert not new, "port txn rerun violations:\n" + "\n".join(
        f"[{v['engine']}] {v['closure']}: {v['detail']}" for v in new)


def _close(m) -> None:
    """Release the engine's database handle on this thread, so the other
    package can open the same file."""
    client = getattr(m, "client", None)
    if client is not None:
        client.close()
        return
    conn = getattr(m._tlocal, "conn", None)
    if conn is not None:
        conn.close()
        m._tlocal.conn = None


def test_sql_scheme_opens_the_relational_engine(tmp_path):
    m = PACKAGES["port"][0].new_client(f"sql://{tmp_path}/m.db")
    try:
        assert isinstance(m, SQLMeta) and m.name() == "sql"
        assert type(m).__module__ == "juicefs_tpu_torch.meta.sql"
    finally:
        _close(m)


@pytest.mark.parametrize("seed,trash_days,n_ops", [
    (7, 0, 900), (99, 1, 900), (2024, 0, 900),
])
def test_random_ops_agree_across_engines(tmp_path, seed, trash_days, n_ops):
    """Three engines, two packages: the reference's sql://, the port's
    sql:// and the port's kv engine agree step for step."""
    engines = {
        "ref-sql": ("ref", f"sql://{tmp_path}/ref-rel.db"),
        "port-sql": ("port", f"sql://{tmp_path}/port-rel.db"),
        "port-kv": ("port", f"sqlite3://{tmp_path}/port-kv.db"),
    }
    doubled0 = txnwatch.state().doubled
    drivers, clients = {}, []
    try:
        for name, (pkg, uri) in engines.items():
            m = PACKAGES[pkg][0].new_client(uri)
            clients.append(m)
            assert m.init(PACKAGES[pkg][1].Format(
                name="rnd", trash_days=trash_days, enable_acl=True),
                force=True) == 0
            m.load()
            drivers[name] = Driver(m, pkg)
        for i, op in enumerate(gen_ops(seed, n_ops)):
            want = drivers["ref-sql"].apply(op)
            for name in ("port-sql", "port-kv"):
                got = drivers[name].apply(op)
                assert got == want, \
                    f"step {i} {op}: ref-sql {want!r}, {name} {got!r}"
        tree = drivers["ref-sql"].tree()
        assert tree, "random sequence produced an empty tree"
        assert drivers["port-sql"].tree() == tree
        assert drivers["port-kv"].tree() == tree
    finally:
        for m in clients:
            _close(m)
    # the port's sql closures really ran twice under its own harness
    assert txnwatch.state().doubled > doubled0


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_sql_file_opens_in_the_other_package(tmp_path, writer, reader):
    uri = f"sql://{tmp_path}/meta.db"
    w = PACKAGES[writer][0].new_client(uri)
    _populate(writer, w)
    want = _volume(writer, w)
    _close(w)
    r = PACKAGES[reader][0].new_client(uri)
    try:
        assert _volume(reader, r) == want
        assert len(want["slices"]) == 2 and len(want["aliases"]) == 4
        r.set_block_digests([(9, 0, 7, b"\x09" * 32)])
        assert (9, 0, 7, b"\x09" * 32) in list(r.scan_block_digests())
    finally:
        _close(r)


def test_content_plane_and_digest_index_match_reference(tmp_path):
    """One call sequence through both packages' sql engines: every return
    value and every scan is equal (alias timestamps aside)."""
    engines = {pkg: PACKAGES[pkg][0].new_client(f"sql://{tmp_path}/{pkg}.db")
               for pkg in PACKAGES}
    d = [bytes([7, i]) * 16 for i in range(3)]
    calls = [
        ("set_block_digests", [(1, 0, 100, d[0]), (2, 0, 100, d[0]), (3, 1, 50, d[1])]),
        ("content_incref", [(d[0], 2, 0, 100)]),
        ("content_register", [(d[0], 1, 0, 100), (d[1], 3, 1, 50)]),
        ("content_register", [(d[0], 4, 0, 100)]),
        ("content_incref", [(d[0], 2, 0, 100), (d[2], 5, 0, 9)]),
        ("content_resolve", 2, 0),
        ("content_resolve", 9, 9),
        ("content_decref", [(4, 0), (9, 9)]),
        ("content_decref", [(3, 1)]),
        ("content_set_refs", d[0], 5),
        ("content_delete_aliases", [(2, 0)]),
        ("delete_block_digests", [(2, 0), (8, 8)]),
        ("set_hot_fingerprints", [(b"h" * 8, d[2])]),
    ]
    try:
        for pkg, m in engines.items():
            assert m.init(PACKAGES[pkg][1].Format(name="cr", trash_days=0),
                          force=True) == 0
            m.load()
        for call in calls:
            out = {pkg: getattr(m, call[0])(*call[1:]) for pkg, m in engines.items()}
            assert out["port"] == out["ref"], call
            scans = {pkg: (sorted(m.scan_block_digests()), sorted(m.scan_content_refs()),
                           sorted((k, dg, b) for k, dg, b, _ts in m.scan_content_aliases()),
                           m.load_hot_fingerprints())
                     for pkg, m in engines.items()}
            assert scans["port"] == scans["ref"], call
    finally:
        for m in engines.values():
            _close(m)


def _plane_record(key: bytes) -> bool:
    """The content-ref plane's records: H{digest}, G{sid,indx} and hotfp."""
    return key == b"hotfp" or (key[:1] == b"H" and len(key) == 33) \
        or (key[:1] == b"G" and len(key) == 13)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_export_kv_records_equal_record_for_record(tmp_path, writer):
    """One sql:// file, exported by both packages: the port's records are
    the reference's, in the same order, plus the content-ref plane's (the
    reference's export drops them), and so are the dump documents'."""
    uri = f"sql://{tmp_path}/meta.db"
    w = PACKAGES[writer][0].new_client(uri)
    _populate(writer, w)
    _close(w)
    got = {}
    for pkg in PACKAGES:
        m = PACKAGES[pkg][0].new_client(uri)
        try:
            records = list(m.export_kv_records())
            doc = (ref_dump if pkg == "ref" else port_dump).dump_doc(m)
        finally:
            _close(m)
        got[pkg] = (records, doc)
    port_records, port_doc = got["port"]
    ref_records, ref_doc = got["ref"]
    assert [r for r in port_records if not _plane_record(r[0])] == ref_records
    assert not any(_plane_record(k) for k, _v in ref_records)
    plane = [k for k, _v in port_records if _plane_record(k)]
    # the populated volume: 2 refs, 4 aliases, one hot-fingerprint blob
    assert sorted(k[:1] for k in plane) == [b"G"] * 4 + [b"H"] * 2 + [b"h"]
    assert len(ref_records) > 20
    decoded = [[bytes(port_dump.base64.b64decode(k)), v] for k, v in port_doc["records"]]
    assert [[port_dump.base64.b64encode(k).decode(), v] for k, v in decoded
            if not _plane_record(k)] == ref_doc["records"]
    assert port_doc["engine"] == ref_doc["engine"] == "sql"


@pytest.mark.parametrize("target", ["sql", "sqlite3"])
def test_port_dump_of_sql_loads_into_either_family(tmp_path, target):
    """The port's dump of a sql:// volume loads into a fresh sql:// or
    sqlite3:// volume of the port with everything it holds, the content-ref
    plane (refs, aliases with their timestamps, hot fingerprints)
    included, and the reference reads the result as the same volume (the
    engine migration dump/load is for)."""
    src = PACKAGES["port"][0].new_client(f"sql://{tmp_path}/src.db")
    _populate("port", src)
    want = _volume("port", src)
    doc = port_dump.dump_doc(src)
    _close(src)
    uri = f"{target}://{tmp_path}/dst.db"
    dst = PACKAGES["port"][0].new_client(uri)
    assert port_dump.load_doc(dst, doc) == len(doc["records"])
    got = _volume("port", dst)
    _close(dst)
    ref = PACKAGES["ref"][0].new_client(uri)
    try:
        assert _volume("ref", ref) == got
    finally:
        _close(ref)
    assert got == want
    assert len(got["refs"]) == 2 and len(got["aliases"]) == 4 and got["hot"]


def test_sql_content_plane_records_equal_the_kv_engines(tmp_path):
    """A kv volume's H/G/hotfp records, loaded into the port's sql engine
    and exported again, come back byte for byte (alias timestamps
    included)."""
    kv = PACKAGES["port"][0].new_client(f"sqlite3://{tmp_path}/kv.db")
    _populate("port", kv)
    kv_doc = port_dump.dump_doc(kv)
    kv.client.close()
    sql = PACKAGES["port"][0].new_client(f"sql://{tmp_path}/rel.db")
    try:
        port_dump.load_doc(sql, kv_doc)
        sql_doc = port_dump.dump_doc(sql)
    finally:
        _close(sql)

    def plane(doc):
        recs = [(port_dump.base64.b64decode(k), port_dump.base64.b64decode(v))
                for k, v in doc["records"]]
        return sorted((k, v) for k, v in recs if _plane_record(k))

    assert len(plane(kv_doc)) == 7
    assert plane(sql_doc) == plane(kv_doc)


@pytest.mark.parametrize("target", ["sql", "sqlite3"])
def test_reference_loads_the_port_dump(tmp_path, target):
    """A reference client loads the port's sql:// dump: its sql import
    skips the content-ref plane's records, its kv import keeps them as they
    are; the rest of the volume is the port's either way."""
    src = PACKAGES["port"][0].new_client(f"sql://{tmp_path}/src.db")
    _populate("port", src)
    want = _volume("port", src)
    doc = port_dump.dump_doc(src)
    _close(src)
    ref = PACKAGES["ref"][0].new_client(f"{target}://{tmp_path}/ref.db")
    try:
        assert ref_dump.load_doc(ref, doc) == len(doc["records"])
        got = _volume("ref", ref)
    finally:
        _close(ref)
    plane = ("refs", "aliases", "hot")
    assert {k: v for k, v in got.items() if k not in plane} == \
        {k: v for k, v in want.items() if k not in plane}
    if target == "sql":
        assert (got["refs"], got["aliases"], got["hot"]) == ([], [], [])
    else:
        assert (got["refs"], got["aliases"], got["hot"]) == \
            (want["refs"], want["aliases"], want["hot"])


@pytest.mark.parametrize("target", ["sql", "sqlite3"])
def test_dump_load_keeps_elided_blocks_readable(tmp_path, target):
    """An inline-dedup volume on the port's sql:// engine: its elided
    blocks read back exactly through a cold store on the loaded volume's
    content refs, one GET of each stored object."""
    from juicefs_tpu_torch.object.file import FileStorage

    bs = 1 << 16
    src = PACKAGES["port"][0].new_client(f"sql://{tmp_path}/src.db")
    assert src.init(PACKAGES["port"][1].Format(name="dd", trash_days=0,
                                               block_size=bs >> 10), force=True) == 0
    src.load()
    storage = FileStorage(str(tmp_path / "blob"))
    storage.create()
    gets: list[str] = []

    class Counting(FileStorage):
        def get(self, key, off=0, limit=-1):
            gets.append(key)
            return super().get(key, off, limit)

    store = CachedStore(storage, ChunkConfig(block_size=bs, cache_size=1))
    store.content_refs = ContentRefs(src)
    store.ingest = IngestPipeline(store, store.content_refs, backend="cpu",
                                  batch_blocks=4, flush_timeout=0.005)
    pool = [os.urandom(bs) for _ in range(2)]
    slices = {sid: [pool[(sid + j) % 2] if j % 2 else os.urandom(bs) for j in range(4)]
              for sid in (1, 2, 3)}
    try:
        for sid, blocks in slices.items():
            w = store.new_writer(sid)
            w.write_at(b"".join(blocks), 0)
            w.finish(len(blocks) * bs)
        store.ingest.flush()
        elided = store.ingest.stats()["put_elided"]
    finally:
        store.close()
    assert elided == 4  # each pool block is stored once, then aliased
    doc = port_dump.dump_doc(src)
    _close(src)
    dst = PACKAGES["port"][0].new_client(f"{target}://{tmp_path}/dst.db")
    port_dump.load_doc(dst, doc)
    cold = CachedStore(Counting(str(tmp_path / "blob")),
                       ChunkConfig(block_size=bs, cache_size=64 << 20))
    cold.content_refs = ContentRefs(dst)
    try:
        for sid, blocks in slices.items():
            assert bytes(cold.new_reader(sid, 4 * bs).read(0, 4 * bs)) == b"".join(blocks)
    finally:
        cold.close()
        _close(dst)
    stored = {o.key for o in storage.list_all("chunks/")}
    assert len(stored) == 12 - elided
    assert sorted(gets) == sorted(stored)
    assert {block_key(sid, j, bs) for sid in slices for j in range(4)} - stored


def test_port_txnwatch_guards_the_sql_seam(tmp_path):
    """The harness wraps the port's sql seam: a closure that is not
    rerun-pure is reported as a violation of the sql engine."""
    m = SQLMeta(str(tmp_path / "tw.db"))
    calls = []

    def impure(cur):
        calls.append(1)
        cur.execute("INSERT OR REPLACE INTO setting (name, value) VALUES (?, ?)",
                    ("tw", str(len(calls))))
        return 0

    try:
        with txnwatch.scoped_state() as st:
            m._txn(impure)
            found = st.snapshot()
        assert len(calls) == 2, "a doubled run calls the closure twice"
        assert found and found[0]["engine"] == "sql"
    finally:
        _close(m)
