"""Twins of tests/test_quota_advice.py and tests/test_quota_bgjobs.py on
the port: quota accounting across create, write, clone, rename, exchange,
symlink, truncate and fallocate (on the kv engine over mem:// and
sqlite3://), then `quota set|get|check` and `mdtest` through the port's
CLI, trash cleanup, meta backup rotation and the background jobs; then
one seeded op sequence on both packages' engines gives the same statuses
and usage. The port's txn closures run twice under its rerun harness."""

import errno
import json
import os

import pytest

from juicefs_tpu_torch.cmd import main
from juicefs_tpu_torch.meta import Format, ROOT_INODE, Slice, new_client
from juicefs_tpu_torch.meta.context import BACKGROUND, Context
from juicefs_tpu_torch.meta.types import TRASH_INODE
from juicefs_tpu_torch.vfs import ROOT_INO, VFS
from juicefs_tpu_torch.vfs.backup import BackgroundJobs, backup_meta, cleanup_trash
from torch_txnwatch import port_txnwatch, port_txnwatch_guard  # noqa: F401

CTX = Context(uid=0, gid=0)
MIB = 1 << 20


@pytest.fixture(params=["memkv", "sqlite3"])
def m(request, tmp_path):
    uri = "memkv://advice" if request.param == "memkv" else f"sqlite3://{tmp_path}/meta.db"
    client = new_client(uri)
    client.init(Format(name="advtest", trash_days=0), force=True)
    client.load()
    client.new_session()
    yield client
    client.close_session()


def _write_file(m, parent, name, nbytes):
    st, ino, _ = m.create(CTX, parent, name, 0o644)
    assert st == 0
    sid = m.new_slice()
    assert m.write_chunk(ino, 0, 0, Slice(pos=0, id=sid, size=nbytes, off=0, len=nbytes)) == 0
    m.close(CTX, ino)
    return ino


def _quota_used(m, ino):
    rec = m.get_dir_quota(ino)
    assert rec is not None
    _sl, _il, used_space, used_inodes = rec
    return used_space, used_inodes


def test_rejected_create_leaks_no_counters(m):
    """EDQUOT-rejected create must not leak totalInodes."""
    st, dino, _ = m.mkdir(CTX, ROOT_INODE, b"lim", 0o755)
    assert m.set_dir_quota(CTX, dino, 0, 1) == 0
    _, _, iused0, _ = m.statfs(CTX)
    st, _, _ = m.create(CTX, dino, b"a", 0o644)
    assert st == 0
    _, _, iused1, _ = m.statfs(CTX)
    assert iused1 == iused0 + 1
    for i in range(3):
        st, _, _ = m.create(CTX, dino, b"b%d" % i, 0o644)
        assert st == errno.EDQUOT
    _, _, iused2, _ = m.statfs(CTX)
    assert iused2 == iused1  # no leak from the rejected creates


def test_rejected_write_leaks_no_space(m):
    """EDQUOT-rejected write_chunk must not leak usedSpace."""
    st, dino, _ = m.mkdir(CTX, ROOT_INODE, b"lim", 0o755)
    assert m.set_dir_quota(CTX, dino, MIB, 0) == 0
    ino = _write_file(m, dino, b"f", MIB)
    _, avail0, _, _ = m.statfs(CTX)
    sid = m.new_slice()
    st = m.write_chunk(
        ino, 1, 0, Slice(pos=0, id=sid, size=MIB, off=0, len=MIB)
    )
    assert st == errno.EDQUOT
    _, avail1, _, _ = m.statfs(CTX)
    assert avail1 == avail0  # rejected write left global usage untouched


def test_clone_charges_subtree_to_quota(m):
    """Cloned subtrees must be visible to the target quota."""
    st, src, _ = m.mkdir(CTX, ROOT_INODE, b"src", 0o755)
    _write_file(m, src, b"data", MIB)
    st, dst, _ = m.mkdir(CTX, ROOT_INODE, b"dst", 0o755)
    assert m.set_dir_quota(CTX, dst, 100 * MIB, 100) == 0
    assert m.clone(CTX, src, dst, b"copy")[0] == 0
    used_space, used_inodes = _quota_used(m, dst)
    assert used_inodes == 2  # dir + file, not just the root entry
    assert used_space >= MIB + 4096
    # deleting the clone must bring usage back to zero, not negative
    assert m.remove_recursive(CTX, dst, b"copy")[0] == 0
    used_space, used_inodes = _quota_used(m, dst)
    assert (used_space, used_inodes) == (0, 0)


def test_rename_transfers_subtree_between_quotas(m):
    """Dir rename must move full subtree usage between quota trees and
    enforce the destination quota."""
    st, qa, _ = m.mkdir(CTX, ROOT_INODE, b"qa", 0o755)
    st, qb, _ = m.mkdir(CTX, ROOT_INODE, b"qb", 0o755)
    assert m.set_dir_quota(CTX, qa, 100 * MIB, 100) == 0
    assert m.set_dir_quota(CTX, qb, 100 * MIB, 100) == 0
    st, sub, _ = m.mkdir(CTX, qa, b"sub", 0o755)
    _write_file(m, sub, b"data", MIB)
    space_a, inodes_a = _quota_used(m, qa)
    assert inodes_a == 2 and space_a >= MIB + 4096
    assert m.rename(CTX, qa, b"sub", qb, b"sub")[0] == 0
    assert _quota_used(m, qa) == (0, 0)  # source fully released
    space_b, inodes_b = _quota_used(m, qb)
    assert (space_b, inodes_b) == (space_a, inodes_a)


def test_rename_enforces_destination_quota(m):
    st, qa, _ = m.mkdir(CTX, ROOT_INODE, b"qa", 0o755)
    st, qb, _ = m.mkdir(CTX, ROOT_INODE, b"qb", 0o755)
    assert m.set_dir_quota(CTX, qb, MIB, 0) == 0
    st, sub, _ = m.mkdir(CTX, qa, b"sub", 0o755)
    _write_file(m, sub, b"data", 2 * MIB)
    st, _, _ = m.rename(CTX, qa, b"sub", qb, b"sub")
    assert st == errno.EDQUOT
    # file rename is checked too
    _write_file(m, qa, b"big", 2 * MIB)
    st, _, _ = m.rename(CTX, qa, b"big", qb, b"big")
    assert st == errno.EDQUOT
    # within one quota tree a rename never EDQUOTs (usage is unchanged)
    assert m.set_dir_quota(CTX, qa, 4 * MIB, 0) == 0
    assert m.rename(CTX, qa, b"big", qa, b"big2")[0] == 0


def test_rename_same_quota_tree_keeps_usage(m):
    st, q, _ = m.mkdir(CTX, ROOT_INODE, b"q", 0o755)
    assert m.set_dir_quota(CTX, q, 100 * MIB, 100) == 0
    st, d1, _ = m.mkdir(CTX, q, b"d1", 0o755)
    st, d2, _ = m.mkdir(CTX, q, b"d2", 0o755)
    st, sub, _ = m.mkdir(CTX, d1, b"sub", 0o755)
    _write_file(m, sub, b"data", MIB)
    space0, inodes0 = _quota_used(m, q)
    assert m.rename(CTX, d1, b"sub", d2, b"sub")[0] == 0
    assert _quota_used(m, q) == (space0, inodes0)


def test_exchange_rename_transfers_usage(m):
    st, qa, _ = m.mkdir(CTX, ROOT_INODE, b"qa", 0o755)
    st, qb, _ = m.mkdir(CTX, ROOT_INODE, b"qb", 0o755)
    assert m.set_dir_quota(CTX, qa, 100 * MIB, 100) == 0
    assert m.set_dir_quota(CTX, qb, 100 * MIB, 100) == 0
    _write_file(m, qa, b"big", 3 * MIB)
    _write_file(m, qb, b"small", MIB)
    from juicefs_tpu_torch.meta.types import RENAME_EXCHANGE

    assert m.rename(CTX, qa, b"big", qb, b"small", RENAME_EXCHANGE)[0] == 0
    space_a, inodes_a = _quota_used(m, qa)
    space_b, inodes_b = _quota_used(m, qb)
    assert inodes_a == 1 and inodes_b == 1
    assert space_a == MIB and space_b == 3 * MIB


def test_symlink_quota_symmetry(m):
    """symlink create must charge what unlink releases (review finding:
    create charged 0, unlink released 4096 -> negative usage)."""
    st, dino, _ = m.mkdir(CTX, ROOT_INODE, b"q", 0o755)
    assert m.set_dir_quota(CTX, dino, 10 * MIB, 10) == 0
    for _ in range(3):
        st, _, _ = m.symlink(CTX, dino, b"l", b"/target/path")
        assert st == 0
        assert m.unlink(CTX, dino, b"l") == 0
    assert _quota_used(m, dino) == (0, 0)
    # and a symlink's usage survives a cross-quota rename round trip
    st, other, _ = m.mkdir(CTX, ROOT_INODE, b"other", 0o755)
    assert m.set_dir_quota(CTX, other, 10 * MIB, 10) == 0
    st, _, _ = m.symlink(CTX, dino, b"l2", b"/t")
    used = _quota_used(m, dino)
    assert m.rename(CTX, dino, b"l2", other, b"l2")[0] == 0
    assert _quota_used(m, dino) == (0, 0)
    assert _quota_used(m, other) == used


def test_deep_tree_rename_no_recursion(m):
    """cross-quota rename of a deep dir chain must not hit the Python
    recursion limit (review finding: _tree_usage was recursive)."""
    st, qa, _ = m.mkdir(CTX, ROOT_INODE, b"qa", 0o755)
    st, qb, _ = m.mkdir(CTX, ROOT_INODE, b"qb", 0o755)
    assert m.set_dir_quota(CTX, qb, 0, 5000) == 0
    parent = qa
    st, top, _ = m.mkdir(CTX, parent, b"d", 0o755)
    parent = top
    for _ in range(1500):
        st, parent, _ = m.mkdir(CTX, parent, b"d", 0o755)
        assert st == 0
    assert m.rename(CTX, qa, b"d", qb, b"d")[0] == 0
    assert _quota_used(m, qb)[1] == 1501


def test_deep_tree_clone_no_recursion(m):
    """clone of a deep dir chain must not hit the recursion limit."""
    st, top, _ = m.mkdir(CTX, ROOT_INODE, b"deep", 0o755)
    parent = top
    for _ in range(1500):
        st, parent, _ = m.mkdir(CTX, parent, b"d", 0o755)
        assert st == 0
    _write_file(m, parent, b"leaf", 4096)
    st, new_root = m.clone(CTX, top, ROOT_INODE, b"deepcopy")
    assert st == 0 and new_root
    # the deepest file made it across
    cur = new_root
    for _ in range(1500):
        st, cur, _ = m.lookup(CTX, cur, b"d")
        assert st == 0
    st, leaf, attr = m.lookup(CTX, cur, b"leaf")
    assert st == 0 and attr.length == 4096


def test_replace_rename_net_zero_no_edquot(m):
    """atomic-replace (write temp, rename over) must not EDQUOT when the
    net usage change is zero (review finding)."""
    st, qa, _ = m.mkdir(CTX, ROOT_INODE, b"qa", 0o755)
    st, qb, _ = m.mkdir(CTX, ROOT_INODE, b"qb", 0o755)
    assert m.set_dir_quota(CTX, qb, 2 * MIB, 0) == 0
    _write_file(m, qb, b"cfg", 2 * MIB)  # quota exactly full
    _write_file(m, qa, b"cfg.tmp", 2 * MIB)
    st, _, _ = m.rename(CTX, qa, b"cfg.tmp", qb, b"cfg")
    assert st == 0
    assert _quota_used(m, qb)[0] == 2 * MIB
    # but a replace that grows usage is still rejected
    _write_file(m, qa, b"big.tmp", 3 * MIB)
    st, _, _ = m.rename(CTX, qa, b"big.tmp", qb, b"cfg")
    assert st == errno.EDQUOT


def test_truncate_and_fallocate_respect_quota(m):
    """Growth via truncate/fallocate must hit EDQUOT."""
    st, dino, _ = m.mkdir(CTX, ROOT_INODE, b"lim", 0o755)
    assert m.set_dir_quota(CTX, dino, MIB, 0) == 0
    st, ino, _ = m.create(CTX, dino, b"f", 0o644)
    st, _ = m.truncate(CTX, ino, 4 * MIB)
    assert st == errno.EDQUOT
    assert m.fallocate(CTX, ino, 0, 0, 4 * MIB) == errno.EDQUOT
    # within the quota both succeed
    st, _ = m.truncate(CTX, ino, MIB // 2)
    assert st == 0
    assert m.fallocate(CTX, ino, 0, 0, MIB - 4096) == 0


def test_quota_check_repairs_drift(m):
    """`quota check --repair` path: recompute true usage from a tree
    walk and heal counters drifted by the hint window."""
    st, dino, _ = m.mkdir(CTX, ROOT_INODE, b"qd", 0o755)
    assert m.set_dir_quota(CTX, dino, 1 << 30, 1000) == 0
    st, f, _ = m.create(CTX, dino, b"f", 0o644)
    m.close(CTX, f)

    st, stored, actual = m.check_dir_quota(CTX, dino)
    assert st == 0 and stored == actual  # normal path: no drift

    # corrupt the stored usage (simulating a missed hint-window update)
    sl, il, us, ui = m.get_dir_quota(dino)
    m.client.txn(lambda tx: tx.set(
        m._dirquota_key(dino), m._QFMT.pack(sl, il, us + 12345, ui + 7)
    ))
    st, stored, actual = m.check_dir_quota(CTX, dino)
    assert st == 0 and stored != actual  # drift detected, not repaired
    assert m.get_dir_quota(dino)[2] == us + 12345

    st, stored, actual = m.check_dir_quota(CTX, dino, repair=True)
    assert st == 0
    assert m.get_dir_quota(dino)[2:] == actual  # healed
    st, stored, actual = m.check_dir_quota(CTX, dino)
    assert stored == actual



# -- parity: one seeded op sequence on both packages' engines ---------------

def _quota_drive(meta_mod, slice_cls, ctx, uri, seed):
    """Apply one seeded sequence of creates, writes, mkdirs, renames
    (plain and exchange), unlinks, truncates and fallocates under two
    quota trees; return every status and the final quota usage."""
    import random

    rng = random.Random(seed)
    m = meta_mod.new_client(uri)
    m.init(meta_mod.Format(name="qparity", trash_days=0), force=True)
    m.load()
    out, dirs, files = [], [], []
    for i in range(2):
        st, dino, _ = m.mkdir(ctx, ROOT_INODE, f"q{i}".encode(), 0o755)
        out.append(st)
        out.append(m.set_dir_quota(ctx, dino, rng.choice([8, 16]) * MIB,
                                   rng.choice([6, 12])))
        dirs.append(dino)
    for step in range(160):
        op = rng.choice(["create", "create", "mkdir", "rename", "exchange", "unlink",
                         "truncate", "fallocate"])
        d = rng.choice(dirs)
        name = f"n{rng.randint(0, 9)}".encode()
        if op == "create":
            st, ino, _ = m.create(ctx, d, name, 0o644)
            out.append((op, st))
            if st == 0:
                n = rng.randint(1, 3) * MIB
                sid = m.new_slice()
                out.append(m.write_chunk(ino, 0, 0, slice_cls(pos=0, id=sid, size=n, off=0,
                                                               len=n)))
                m.close(ctx, ino)
                files.append((d, name, ino))
        elif op == "mkdir":
            out.append((op, m.mkdir(ctx, d, name, 0o755)[0]))
        elif op in ("rename", "exchange"):
            flags = 2 if op == "exchange" else 0
            st = m.rename(ctx, d, name, rng.choice(dirs), f"n{rng.randint(0, 9)}".encode(),
                          flags)[0]
            out.append((op, st))
        elif op == "unlink":
            out.append((op, m.unlink(ctx, d, name)))
        elif files:
            _d, _n, ino = rng.choice(files)
            if op == "truncate":
                out.append((op, m.truncate(ctx, ino, rng.randint(0, 4) * MIB)[0]))
            else:
                out.append((op, m.fallocate(ctx, ino, 0, 0, rng.randint(1, 4) * MIB)))
    out.append([m.get_dir_quota(dino) for dino in dirs])
    out.append(m.statfs(ctx)[2:])
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_quota_accounting_matches_reference(seed):
    from juicefs_tpu import meta as ref_meta
    from juicefs_tpu.meta.context import Context as RefContext
    from juicefs_tpu_torch import meta as port_meta

    got = _quota_drive(port_meta, Slice, CTX, f"memkv://qp{seed}", seed)
    want = _quota_drive(ref_meta, ref_meta.Slice, RefContext(uid=0, gid=0),
                        f"memkv://qr{seed}", seed)
    assert got == want
    assert errno.EDQUOT in {x[1] for x in got if isinstance(x, tuple) and isinstance(x[0], str)}

# -- quota subcommands, trash cleanup and the background jobs --------------

BG_CTX = Context(uid=0, gid=0, pid=1)


@pytest.fixture
def vol(tmp_path):
    meta_url = f"sqlite3://{tmp_path}/meta.db"
    assert main([
        "format", meta_url, "qvol", "--storage", "file",
        "--bucket", str(tmp_path / "blobs"), "--block-size", "64",
    ]) == 0
    return meta_url, tmp_path


def _vfs(meta_url, tmp_path, n=0):
    from juicefs_tpu_torch.cmd import build_store, open_meta

    class A:
        cache_dir = str(tmp_path / f"c{n}")
        writeback = False
        cache_size = 0

    m, fmt = open_meta(meta_url)
    m.new_session()
    return VFS(m, build_store(fmt, A()), fmt=fmt)


def test_quota_enforced_on_create_and_write(vol, capsys):
    meta_url, tmp = vol
    v = _vfs(meta_url, tmp)
    st, dino, _ = v.mkdir(BG_CTX, ROOT_INO, b"limited", 0o755)
    v.close()
    # 1 MiB space, 5 inode quota
    assert main(["quota", "set", meta_url, "/limited",
                 "--space", str(1 / 1024), "--inodes", "5"]) == 0
    capsys.readouterr()
    v = _vfs(meta_url, tmp, 1)
    st, dino, _ = v.lookup(BG_CTX, ROOT_INO, b"limited")
    # inode limit: 5 creates ok, 6th rejected
    for i in range(5):
        st, ino, _, fh = v.create(BG_CTX, dino, f"f{i}".encode(), 0o644)
        assert st == 0
        v.release(BG_CTX, ino, fh)
    st, _, _, _ = v.create(BG_CTX, dino, b"f5", 0o644)
    assert st == errno.EDQUOT
    # space limit: writing 2 MiB into a 1 MiB quota fails at commit
    st, ino, _ = v.lookup(BG_CTX, dino, b"f0")
    st, attr, fh = v.open(BG_CTX, ino, os.O_RDWR)
    assert v.write(BG_CTX, ino, fh, 0, os.urandom(2 << 20)) == 0  # buffered
    assert v.flush(BG_CTX, ino, fh) == errno.EDQUOT
    v.release(BG_CTX, ino, fh)
    # subtree under quota dir is also charged
    st, sub, _ = v.mkdir(BG_CTX, dino, b"sub", 0o755)
    assert st == errno.EDQUOT  # inode quota still exhausted
    v.close()
    assert main(["quota", "get", meta_url, "/limited"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["used_inodes"] == 5


def test_quota_released_on_unlink(vol, capsys):
    meta_url, tmp = vol
    v = _vfs(meta_url, tmp)
    st, dino, _ = v.mkdir(BG_CTX, ROOT_INO, b"q2", 0o755)
    v.close()
    assert main(["quota", "set", meta_url, "/q2", "--inodes", "2"]) == 0
    v = _vfs(meta_url, tmp, 1)
    st, dino, _ = v.lookup(BG_CTX, ROOT_INO, b"q2")
    st, a, _, fh = v.create(BG_CTX, dino, b"a", 0o644)
    v.release(BG_CTX, a, fh)
    st, b, _, fh = v.create(BG_CTX, dino, b"b", 0o644)
    v.release(BG_CTX, b, fh)
    st, _, _, _ = v.create(BG_CTX, dino, b"c", 0o644)
    assert st == errno.EDQUOT
    assert v.meta.unlink(BG_CTX, dino, b"a", skip_trash=True) == 0
    st, c, _, fh = v.create(BG_CTX, dino, b"c", 0o644)
    assert st == 0
    v.close()


def test_mdtest_runs(vol, capsys):
    meta_url, tmp = vol
    assert main(["mdtest", meta_url, "--dirs", "3", "--files", "10"]) == 0
    results = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert results["file_create_per_s"] > 0
    assert results["file_stat_per_s"] > 0


def test_trash_cleanup(vol):
    meta_url, tmp = vol
    v = _vfs(meta_url, tmp)
    m = v.meta
    st, ino, _, fh = v.create(BG_CTX, ROOT_INO, b"old.txt", 0o644)
    v.release(BG_CTX, ino, fh)
    assert v.unlink(BG_CTX, ROOT_INO, b"old.txt") == 0  # into trash
    # nothing expires yet (trash_days=1, entry is fresh)
    assert cleanup_trash(m, m.fmt.trash_days) == 0
    # with a 0-day horizon everything already expired
    assert cleanup_trash(m, -1) >= 1
    st, entries = m.readdir(BACKGROUND, TRASH_INODE)
    live = [e for e in entries if e.name not in (b".", b"..")]
    for e in live:
        st, sub = m.readdir(BACKGROUND, e.inode)
    v.close()


def test_meta_backup_and_rotation(vol):
    meta_url, tmp = vol
    v = _vfs(meta_url, tmp)
    _ = v.create(BG_CTX, ROOT_INO, b"data", 0o644)
    storage = v.store.storage
    keys = [backup_meta(v.meta, storage) for _ in range(3)]
    backups = [o.key for o in storage.list_all("meta/") if o.key.endswith(".json.gz")]
    assert len(backups) >= 1 and keys[-1] in backups
    # round-trip the newest backup into a fresh engine
    import gzip as _gzip
    import json as _json

    from juicefs_tpu_torch.meta.dump import load_doc

    doc = _json.loads(_gzip.decompress(bytes(storage.get(keys[-1]))))
    m2 = new_client("mem://")
    load_doc(m2, doc)
    m2.load()
    st, ino, attr = m2.lookup(BG_CTX, ROOT_INODE, b"data")
    assert st == 0
    v.close()


def test_background_jobs_run_once(vol):
    meta_url, tmp = vol
    v = _vfs(meta_url, tmp)
    bg = BackgroundJobs(v.meta, v.store, interval=3600)
    assert bg._elect()
    stats = bg.run_once()
    assert "backup" in stats
    assert stats.get("deleted_files", 0) >= 0
    # a second session with a live lease is not elected
    v2 = _vfs(meta_url, tmp, 1)
    bg2 = BackgroundJobs(v2.meta, v2.store, interval=3600)
    assert not bg2._elect()
    v2.close()
    v.close()
