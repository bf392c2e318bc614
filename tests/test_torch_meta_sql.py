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
  - `export_kv_records` of one file is equal record for record in both
    packages, so the port's `dump` of a sql:// volume is the reference's,
    and a dump loads back into either engine family.

The port's sql closures run under the port's own rerun harness
(juicefs_tpu_torch/utils/txnwatch.py), installed for the whole module: each
successful closure runs twice (rolled back to a savepoint in between) and
any divergence fails the test.
"""

from __future__ import annotations

import pytest

from juicefs_tpu.meta import dump as ref_dump
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


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_export_kv_records_equal_record_for_record(tmp_path, writer):
    """One sql:// file, exported by both packages: the same records in the
    same order, and the same dump document."""
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
    assert got["port"][0] == got["ref"][0]
    assert len(got["port"][0]) > 20
    assert got["port"][1] == got["ref"][1]
    assert got["port"][1]["engine"] == "sql"


@pytest.mark.parametrize("target", ["sql", "sqlite3"])
def test_port_dump_of_sql_loads_into_either_family(tmp_path, target):
    """The port's dump of a sql:// volume loads into a fresh sql:// or
    sqlite3:// volume of the port, and the reference reads the result as
    the same volume (the engine migration dump/load is for)."""
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
    # the sql export carries the namespace, slices and digest rows; like
    # the reference's it has no records for the content-ref plane (refs,
    # aliases, hot fingerprints), so those are not compared here
    for key in ("format", "tree", "slices", "digests"):
        assert got[key] == want[key], key


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
