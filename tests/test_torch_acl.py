"""Twin of tests/test_acl.py on the port, then its rules and codecs held
against the reference's on seeded rules. POSIX ACLs end to end (reference
pkg/acl/acl.go rules,
pkg/meta/tkv.go:3594-3689 facl ops, pkg/vfs/vfs.go:1040-1160 xattr bridge):
rule evaluation, the kernel xattr codec, chmod interplay, default-ACL
inheritance at mknod, and enforcement through meta access checks."""

import errno
import os

import pytest

from juicefs_tpu_torch.chunk import CachedStore, ChunkConfig
from juicefs_tpu_torch.meta import Format, new_client
from juicefs_tpu_torch.meta import acl
from juicefs_tpu_torch.meta.context import Context
from juicefs_tpu_torch.object import create_storage
from juicefs_tpu_torch.vfs import ROOT_INO, VFS
from torch_txnwatch import port_txnwatch, port_txnwatch_guard  # noqa: F401

ROOT = Context(uid=0, gid=0, pid=1)


# -- rule semantics (reference acl.go CanAccess/SetMode/ChildAccessACL) ----

def test_rule_can_access_owner_and_other():
    r = acl.Rule(owner=6, group=4, mask=acl.UNDEF, other=0)
    assert r.can_access(1000, (1000,), 1000, 1000, 4)       # owner r
    assert not r.can_access(1000, (1000,), 1000, 1000, 1)   # owner no x
    assert not r.can_access(2000, (2000,), 1000, 1000, 4)   # other 0


def test_rule_named_user_limited_by_mask():
    r = acl.Rule(owner=7, group=0, mask=4, other=0, named_users=((1001, 7),))
    assert r.can_access(1001, (1001,), 1000, 1000, 4)       # named user r (7&mask4)
    assert not r.can_access(1001, (1001,), 1000, 1000, 2)   # w masked off


def test_rule_group_deny_does_not_fall_through_to_other():
    # uid in owning group but group class denies: POSIX says stop, do not
    # consult 'other' (reference CanAccess isGrpMatched)
    r = acl.Rule(owner=7, group=0, mask=7, other=7)
    assert not r.can_access(2000, (1000,), 999, 1000, 4)


def test_rule_named_group():
    r = acl.Rule(owner=7, group=0, mask=7, other=0, named_groups=((55, 4),))
    assert r.can_access(2000, (55,), 999, 1000, 4)
    assert not r.can_access(2000, (55,), 999, 1000, 2)


def test_rule_set_mode_routes_group_bits_to_mask():
    r = acl.Rule(owner=7, group=5, mask=7, other=5, named_users=((1001, 7),))
    r.set_mode(0o640)
    assert r.owner == 6 and r.mask == 4 and r.other == 0
    assert r.group == 5  # group class preserved, mask carries the bits
    assert r.get_mode() == 0o640


def test_rule_child_access_acl():
    d = acl.Rule(owner=7, group=5, mask=5, other=5, named_users=((1001, 6),))
    c = d.child_access_acl(0o640)
    assert c.owner == 6          # request owner & default owner
    assert c.mask == 4           # request group bits & default mask
    assert c.other == 0
    assert c.named_users == ((1001, 6),)


def test_storage_codec_roundtrip():
    r = acl.Rule(owner=6, group=4, mask=5, other=0,
                 named_users=((1001, 7), (1002, 4)), named_groups=((55, 5),))
    assert acl.Rule.decode(r.encode()) == r


def test_xattr_codec_kernel_format():
    r = acl.Rule(owner=6, group=4, mask=5, other=0, named_users=((1001, 7),))
    buf = acl.to_xattr(r)
    assert buf[:4] == b"\x02\x00\x00\x00"  # version 2, little-endian
    assert len(buf) == 4 + 5 * 8  # user_obj, named, group_obj, mask, other
    back = acl.from_xattr(buf)
    assert back == r
    # malformed payloads are rejected
    assert acl.from_xattr(buf[:-1]) is None
    assert acl.from_xattr(b"\x01\x00\x00\x00" + buf[4:]) is None
    # extended entries without a mask are invalid
    no_mask = acl.Rule(owner=6, group=4, mask=acl.UNDEF, other=0)
    no_mask.named_users = ((1001, 7),)
    assert acl.from_xattr(acl.to_xattr(no_mask)) is None


# -- end-to-end through VFS + meta -----------------------------------------

@pytest.fixture
def vfs():
    m = new_client("mem://")
    fmt = Format(name="aclvol", storage="mem", enable_acl=True, trash_days=0)
    m.init(fmt, force=False)
    m.new_session()
    store = CachedStore(create_storage("mem://"), ChunkConfig(block_size=1 << 18))
    v = VFS(m, store, fmt=fmt)
    yield v
    v.close()


def _xattr(owner=6, group=4, mask=None, other=0, users=(), groups=()):
    r = acl.Rule(owner=owner, group=group,
                 mask=acl.UNDEF if mask is None else mask,
                 other=other, named_users=tuple(users),
                 named_groups=tuple(groups))
    return acl.to_xattr(r)


def test_set_get_access_acl_updates_mode(vfs):
    st, ino, attr, fh = vfs.create(ROOT, ROOT_INO, b"f", 0o644)
    vfs.release(ROOT, ino, fh)
    val = _xattr(owner=6, group=4, mask=5, other=0, users=((1001, 7),))
    assert vfs.setxattr(ROOT, ino, b"system.posix_acl_access", val) == 0
    # mode now shows owner|mask|other (reference doSetFacl)
    st, attr = vfs.getattr(ROOT, ino)
    assert attr.mode & 0o777 == 0o650
    st, back = vfs.getxattr(ROOT, ino, b"system.posix_acl_access")
    assert st == 0
    rule = acl.from_xattr(back)
    assert rule.named_users == ((1001, 7),) and rule.mask == 5
    # listxattr advertises the ACL name
    st, names = vfs.listxattr(ROOT, ino)
    assert b"system.posix_acl_access" in names


def test_acl_enforced_in_access_checks(vfs):
    st, ino, attr, fh = vfs.create(ROOT, ROOT_INO, b"data", 0o640)
    vfs.release(ROOT, ino, fh)
    # grant uid 1001 read via named-user entry; other stays 0
    val = _xattr(owner=6, group=4, mask=4, other=0, users=((1001, 4),))
    assert vfs.setxattr(ROOT, ino, b"system.posix_acl_access", val) == 0
    user = Context(uid=1001, gid=1001, gids=(1001,), pid=1)
    stranger = Context(uid=2002, gid=2002, gids=(2002,), pid=1)
    st, _, _ = vfs.open(user, ino, os.O_RDONLY)
    assert st == 0
    st, _, _ = vfs.open(stranger, ino, os.O_RDONLY)
    assert st == errno.EACCES
    # mask cut: chmod g-r zeroes the mask, revoking the named user too
    a = __import__("juicefs_tpu_torch.meta.types", fromlist=["Attr"]).Attr(mode=0o600)
    from juicefs_tpu_torch.meta.types import SET_ATTR_MODE

    st, _ = vfs.setattr(ROOT, ino, SET_ATTR_MODE, a)
    assert st == 0
    st, _, _ = vfs.open(user, ino, os.O_RDONLY)
    assert st == errno.EACCES


def test_chmod_updates_mask_not_group(vfs):
    st, ino, _, fh = vfs.create(ROOT, ROOT_INO, b"c", 0o664)
    vfs.release(ROOT, ino, fh)
    val = _xattr(owner=6, group=6, mask=6, other=4, users=((1001, 6),))
    assert vfs.setxattr(ROOT, ino, b"system.posix_acl_access", val) == 0
    from juicefs_tpu_torch.meta.types import Attr, SET_ATTR_MODE

    st, out = vfs.setattr(ROOT, ino, SET_ATTR_MODE, Attr(mode=0o604))
    assert st == 0 and out.mode & 0o777 == 0o604
    st, back = vfs.getxattr(ROOT, ino, b"system.posix_acl_access")
    rule = acl.from_xattr(back)
    assert rule.mask == 0 and rule.group == 6  # group class kept, mask cut


def test_minimal_access_acl_becomes_plain_mode(vfs):
    st, ino, _, fh = vfs.create(ROOT, ROOT_INO, b"m", 0o600)
    vfs.release(ROOT, ino, fh)
    assert vfs.setxattr(ROOT, ino, b"system.posix_acl_access",
                        _xattr(owner=7, group=5, other=1)) == 0
    st, attr = vfs.getattr(ROOT, ino)
    assert attr.mode & 0o777 == 0o751
    # no extended entries -> no stored ACL
    st, _ = vfs.getxattr(ROOT, ino, b"system.posix_acl_access")
    assert st == errno.ENODATA


def test_default_acl_inheritance(vfs):
    st, dino, _ = vfs.mkdir(ROOT, ROOT_INO, b"proj", 0o755)
    val = _xattr(owner=7, group=5, mask=5, other=0, users=((1001, 6),))
    assert vfs.setxattr(ROOT, dino, b"system.posix_acl_default", val) == 0
    # dir's own mode unchanged by a *default* ACL
    st, dattr = vfs.getattr(ROOT, dino)
    assert dattr.mode & 0o777 == 0o755

    # new file inherits an access ACL from the parent's default ACL,
    # umask ignored (cumask=0o022 would normally strip group bits)
    st, ino, attr = vfs.mknod(ROOT, dino, b"f", 0o664, cumask=0o022)
    assert st == 0
    st, back = vfs.getxattr(ROOT, ino, b"system.posix_acl_access")
    assert st == 0
    rule = acl.from_xattr(back)
    assert rule.named_users == ((1001, 6),)
    assert rule.mask == 6 & 5  # request group bits & default mask
    assert attr.mode & 0o777 == 0o640  # owner 7&6=6, mask 4, other 0&0

    # subdirectory inherits BOTH the access and the default ACL
    st, sdino, _ = vfs.mkdir(ROOT, dino, b"sub", 0o755)
    st, dback = vfs.getxattr(ROOT, sdino, b"system.posix_acl_default")
    assert st == 0 and acl.from_xattr(dback).named_users == ((1001, 6),)
    st, aback = vfs.getxattr(ROOT, sdino, b"system.posix_acl_access")
    assert st == 0

    # the named user can read the inherited file
    user = Context(uid=1001, gid=1001, gids=(1001,), pid=1)
    st, _, _ = vfs.open(user, ino, os.O_RDONLY)
    assert st == 0

    # removing the default ACL stops inheritance
    assert vfs.removexattr(ROOT, dino, b"system.posix_acl_default") == 0
    st, ino2, attr2 = vfs.mknod(ROOT, dino, b"g", 0o664, cumask=0o022)
    assert attr2.mode & 0o777 == 0o644  # umask applies again
    st, _ = vfs.getxattr(ROOT, ino2, b"system.posix_acl_access")
    assert st == errno.ENODATA


def test_default_acl_on_file_rejected(vfs):
    st, ino, _, fh = vfs.create(ROOT, ROOT_INO, b"nf", 0o644)
    vfs.release(ROOT, ino, fh)
    st = vfs.setxattr(ROOT, ino, b"system.posix_acl_default", _xattr(mask=4))
    assert st == errno.EACCES


def test_acl_requires_enable_flag():
    m = new_client("mem://")
    fmt = Format(name="noacl", storage="mem")  # enable_acl False
    m.init(fmt, force=False)
    m.new_session()
    v = VFS(m, CachedStore(create_storage("mem://"), ChunkConfig()), fmt=fmt)
    st, ino, _, fh = v.create(ROOT, ROOT_INO, b"f", 0o644)
    v.release(ROOT, ino, fh)
    assert v.setxattr(ROOT, ino, b"system.posix_acl_access", _xattr()) == errno.ENOTSUP
    st, _ = v.getxattr(ROOT, ino, b"system.posix_acl_access")
    assert st == errno.ENOTSUP
    v.close()


def test_setfacl_only_owner_or_root(vfs):
    st, ino, _, fh = vfs.create(ROOT, ROOT_INO, b"own", 0o644)
    vfs.release(ROOT, ino, fh)
    other = Context(uid=1001, gid=1001, gids=(1001,), pid=1)
    st = vfs.setxattr(other, ino, b"system.posix_acl_access", _xattr(mask=4))
    assert st == errno.EPERM


def test_acl_survives_dump_load(vfs, tmp_path):
    from juicefs_tpu_torch.meta.dump import dump_doc, load_doc

    st, ino, _, fh = vfs.create(ROOT, ROOT_INO, b"d", 0o640)
    vfs.release(ROOT, ino, fh)
    val = _xattr(owner=6, group=4, mask=4, other=0, users=((1001, 4),))
    assert vfs.setxattr(ROOT, ino, b"system.posix_acl_access", val) == 0

    doc = dump_doc(vfs.meta)
    m2 = new_client("mem://")
    load_doc(m2, doc, force=True)
    m2.load()
    st, rule = m2.get_facl(ROOT, ino, acl.TYPE_ACCESS)
    assert st == 0 and rule.named_users == ((1001, 4),)


def test_lookup_cache_does_not_bypass_parent_exec_check(vfs):
    """A dentry cached by one user must not let another user traverse a
    directory they lack execute permission on (code-review r3 finding)."""
    st, dino, _ = vfs.mkdir(ROOT, ROOT_INO, b"private", 0o700)
    st, ino, _, fh = vfs.create(ROOT, dino, b"secret", 0o600)
    vfs.release(ROOT, ino, fh)
    # root warms the entry+attr cache
    st, _, _ = vfs.lookup(ROOT, dino, b"secret")
    assert st == 0
    stranger = Context(uid=1000, gid=1000, gids=(1000,), pid=1)
    st, _, _ = vfs.lookup(stranger, dino, b"secret")
    assert st == errno.EACCES


def test_aborted_txn_does_not_poison_acl_ids(vfs):
    """An ACL id allocated in a discarded transaction must not leak into
    later inserts (code-review r3: phantom id -> wrong-ACL enforcement)."""
    m = vfs.meta
    rule_a = acl.Rule(owner=7, group=5, mask=5, other=0,
                      named_users=((1001, 6),))
    rule_b = acl.Rule(owner=6, group=4, mask=4, other=0,
                      named_users=((2002, 4),))

    def aborted(tx):
        m._insert_acl(tx, rule_a)
        tx.discard()
        return 0

    m.client.txn(aborted)
    # no row was persisted by the discarded txn
    assert not list(m.client.scan(b"R", b"S"))

    st, i1, _, fh = vfs.create(ROOT, ROOT_INO, b"one", 0o640)
    vfs.release(ROOT, i1, fh)
    st, i2, _, fh = vfs.create(ROOT, ROOT_INO, b"two", 0o640)
    vfs.release(ROOT, i2, fh)
    assert vfs.setxattr(ROOT, i1, b"system.posix_acl_access",
                        acl.to_xattr(rule_b)) == 0
    assert vfs.setxattr(ROOT, i2, b"system.posix_acl_access",
                        acl.to_xattr(rule_a)) == 0
    st, r1 = vfs.meta.get_facl(ROOT, i1, acl.TYPE_ACCESS)
    st, r2 = vfs.meta.get_facl(ROOT, i2, acl.TYPE_ACCESS)
    assert r1.named_users == ((2002, 4),)
    assert r2.named_users == ((1001, 6),)


def test_default_acl_ops_preserve_sgid(vfs):
    """Setting/removing a DEFAULT ACL never touches the mode, so a setgid
    dir owned by a non-member keeps its sgid bit (code-review r3)."""
    from juicefs_tpu_torch.meta.types import SET_ATTR_GID, SET_ATTR_UID, Attr

    st, dino, _ = vfs.mkdir(ROOT, ROOT_INO, b"sgid", 0o2775)
    # root hands the dir to uid 500 with a group 500 is not in
    st, _ = vfs.setattr(ROOT, dino, SET_ATTR_UID | SET_ATTR_GID,
                        Attr(uid=500, gid=99))
    assert st == 0
    owner = Context(uid=500, gid=500, gids=(500,), pid=1)
    val = _xattr(owner=7, group=5, mask=5, other=0, users=((1001, 6),))
    assert vfs.setxattr(owner, dino, b"system.posix_acl_default", val) == 0
    st, attr = vfs.getattr(ROOT, dino)
    assert attr.mode & 0o7777 == 0o2775  # sgid intact
    assert vfs.removexattr(owner, dino, b"system.posix_acl_default") == 0
    st, attr = vfs.getattr(ROOT, dino)
    assert attr.mode & 0o7777 == 0o2775


# -- parity with the reference's rules and codecs on seeded inputs ---------

def _random_rule(mod, rng):
    undef = mod.UNDEF

    def perm():
        return rng.choice([undef, rng.randint(0, 7)])

    users = tuple((rng.randint(1, 6), rng.randint(0, 7)) for _ in range(rng.randint(0, 3)))
    groups = tuple((rng.randint(1, 6), rng.randint(0, 7)) for _ in range(rng.randint(0, 3)))
    return mod.Rule(perm(), perm(), perm(), perm(), users, groups)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_rules_and_codecs_match_reference(seed):
    """The same seeded rules through both packages: the storage and xattr
    codecs give the same bytes and decode alike, and the predicates, mode
    interplay, child ACLs and access decisions agree."""
    import random

    from juicefs_tpu.meta import acl as ref_acl

    assert acl.UNDEF == ref_acl.UNDEF
    rng = random.Random(seed)
    for _ in range(200):
        state = rng.getstate()
        port = _random_rule(acl, rng)
        rng.setstate(state)
        ref = _random_rule(ref_acl, rng)
        assert port.encode() == ref.encode()
        assert acl.Rule.decode(ref.encode()) == port
        assert acl.to_xattr(port) == ref_acl.to_xattr(ref)
        back, ref_back = acl.from_xattr(ref_acl.to_xattr(ref)), ref_acl.from_xattr(acl.to_xattr(port))
        assert (back is None) == (ref_back is None)
        if back is not None:
            assert back.encode() == ref_back.encode()
        assert (port.is_empty(), port.is_minimal()) == (ref.is_empty(), ref.is_minimal())
        mode = rng.randint(0, 0o777)
        assert port.child_access_acl(mode).encode() == ref.child_access_acl(mode).encode()
        for _ in range(8):
            uid, fuid, fgid = rng.randint(0, 6), rng.randint(0, 6), rng.randint(0, 6)
            gids = rng.sample(range(7), rng.randint(0, 3))
            want = rng.randint(1, 7)
            assert port.can_access(uid, gids, fuid, fgid, want) == \
                ref.can_access(uid, gids, fuid, fgid, want)
        port.inherit_perms(mode)
        ref.inherit_perms(mode)
        port.set_mode(mode ^ 0o123)
        ref.set_mode(mode ^ 0o123)
        assert port.encode() == ref.encode() and port.get_mode() == ref.get_mode()
