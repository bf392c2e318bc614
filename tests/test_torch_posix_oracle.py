"""Twin of tests/test_posix_oracle.py on the port's mount
(tests/torch_fuse_mount.py): ground-truth POSIX model testing (reference analog
.github/scripts/hypo/fs.py): one deterministic random op sequence is
applied op-for-op through REAL syscalls to (a) a live FUSE loop-mount of
the full stack and (b) a scratch directory on the host file system. The
kernel's own fs is the oracle: every step's outcome (errno, bytes
written/read, sizes) must match, and the final trees (structure, modes,
content hashes, symlink targets, xattrs) must be identical.

This is the check the engine-vs-engine random harness cannot do: all
meta engines could share one wrong semantic and still agree with each
other; they cannot agree with ext4/tmpfs unless the semantics are right.

Covers: mkdir/create/write/read/unlink/rmdir/symlink/hardlink/chmod/
truncate (incl. while-open), O_APPEND writes, rename + RENAME_NOREPLACE
+ RENAME_EXCHANGE (renameat2), user xattrs, readdir, stat.
"""

from __future__ import annotations

import ctypes
import errno
import hashlib
import os
import random
import shutil

import pytest

from torch_txnwatch import port_txnwatch, port_txnwatch_guard  # noqa: F401

pytestmark = pytest.mark.skipif(
    not os.path.exists("/dev/fuse") or shutil.which("fusermount") is None,
    reason="FUSE not available",
)

NAMES = [f"n{i}" for i in range(10)]
XKEYS = [b"user.a", b"user.b", b"user.c"]

_libc = ctypes.CDLL(None, use_errno=True)
RENAME_NOREPLACE, RENAME_EXCHANGE = 1, 2
AT_FDCWD = -100


def renameat2(src: str, dst: str, flags: int) -> int:
    """Returns 0 or the errno (Python has no os.rename flags). Uses the
    portable glibc wrapper, not a hardcoded syscall number (arch-specific);
    tests degrade to flag-less renames if libc lacks it."""
    try:
        fn = _libc.renameat2
    except AttributeError:
        return errno.ENOSYS
    r = fn(AT_FDCWD, src.encode(), AT_FDCWD, dst.encode(), flags)
    return ctypes.get_errno() if r != 0 else 0


def _renameat2_flags_supported(root: str) -> bool:
    """True when the fs under `root` really honors RENAME_NOREPLACE and
    RENAME_EXCHANGE.  9p/overlay hosts fail every flagged rename with
    EINVAL while the mount side supports them — semantics the oracle
    can't express there, so the generator degrades to flag-less renames
    (flagged-rename semantics are covered by tests/test_meta.py)."""
    a, b = os.path.join(root, ".r2-a"), os.path.join(root, ".r2-b")
    try:
        for p in (a, b):
            with open(p, "w"):
                pass
        if renameat2(a, a + "x", RENAME_NOREPLACE) != 0:
            return False
        if renameat2(a + "x", b, RENAME_EXCHANGE) != 0:
            return False
        return True
    except OSError:
        return False
    finally:
        for p in (a, a + "x", b):
            try:
                os.unlink(p)
            except OSError:
                pass


def _xattr_supported(root: str) -> bool:
    p = os.path.join(root, ".xattr-probe")
    try:
        with open(p, "w"):
            pass
        os.setxattr(p, b"user.probe", b"1")
        return True
    except OSError:
        return False
    finally:
        try:
            os.unlink(p)
        except OSError:
            pass


class FsDriver:
    """Applies ops to one root via plain syscalls; returns canonical,
    comparable outcomes. Open fds are tracked by slot index so
    truncate-while-open / O_APPEND behave identically on both sides."""

    def __init__(self, root: str):
        self.root = root
        self.fds: dict[int, int] = {}  # slot -> fd

    def _p(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    def close_all(self):
        for fd in self.fds.values():
            try:
                os.close(fd)
            except OSError:
                pass
        self.fds.clear()

    def apply(self, op: tuple) -> tuple:
        kind = op[0]
        try:
            if kind == "mkdir":
                os.mkdir(self._p(op[1]), op[2])
                return (0,)
            if kind == "create":
                fd = os.open(self._p(op[1]),
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY, op[2])
                os.close(fd)
                return (0,)
            if kind == "write":
                _, rel, off, data = op
                fd = os.open(self._p(rel), os.O_WRONLY)
                try:
                    os.lseek(fd, off, os.SEEK_SET)
                    n = os.write(fd, data)
                finally:
                    os.close(fd)
                return (0, n)
            if kind == "append":
                _, rel, data = op
                fd = os.open(self._p(rel), os.O_WRONLY | os.O_APPEND)
                try:
                    n = os.write(fd, data)
                    end = os.lseek(fd, 0, os.SEEK_CUR)
                finally:
                    os.close(fd)
                return (0, n, end)
            if kind == "read":
                _, rel, off, size = op
                fd = os.open(self._p(rel), os.O_RDONLY)
                try:
                    # drop cached pages first so the mount side serves the
                    # read from its own store, not the kernel page cache —
                    # otherwise store-level bugs are invisible here
                    try:
                        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
                    except OSError:
                        pass
                    os.lseek(fd, off, os.SEEK_SET)
                    data = os.read(fd, size)
                finally:
                    os.close(fd)
                return (0, hashlib.sha256(data).hexdigest(), len(data))
            if kind == "shrinkgrow":
                # POSIX: grow-after-shrink must read zeros, never the old
                # data beyond the shrink point (resurrection bug class)
                _, rel, small, big = op
                os.truncate(self._p(rel), small)
                os.truncate(self._p(rel), big)
                fd = os.open(self._p(rel), os.O_RDONLY)
                try:
                    try:
                        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
                    except OSError:
                        pass
                    data = os.read(fd, big)
                finally:
                    os.close(fd)
                return (0, hashlib.sha256(data).hexdigest(), len(data))
            if kind == "open_slot":
                _, slot, rel, flags = op
                old = self.fds.pop(slot, None)
                if old is not None:
                    os.close(old)
                self.fds[slot] = os.open(self._p(rel), flags)
                return (0,)
            if kind == "slot_write":
                _, slot, data = op
                fd = self.fds.get(slot)
                if fd is None:
                    return ("noslot",)
                n = os.write(fd, data)
                return (0, n, os.lseek(fd, 0, os.SEEK_CUR))
            if kind == "slot_truncate":
                _, slot, length = op
                fd = self.fds.get(slot)
                if fd is None:
                    return ("noslot",)
                os.ftruncate(fd, length)
                return (0, os.fstat(fd).st_size)
            if kind == "slot_close":
                fd = self.fds.pop(op[1], None)
                if fd is not None:
                    os.close(fd)
                return (0,)
            if kind == "truncate":
                _, rel, length = op
                os.truncate(self._p(rel), length)
                return (0, os.stat(self._p(rel)).st_size)
            if kind == "unlink":
                os.unlink(self._p(op[1]))
                return (0,)
            if kind == "rmdir":
                os.rmdir(self._p(op[1]))
                return (0,)
            if kind == "symlink":
                os.symlink(op[2], self._p(op[1]))
                return (0,)
            if kind == "readlink":
                return (0, os.readlink(self._p(op[1])))
            if kind == "link":
                os.link(self._p(op[1]), self._p(op[2]))
                return (0, os.stat(self._p(op[2])).st_nlink)
            if kind == "rename":
                _, src, dst, flags = op
                if flags:
                    st = renameat2(self._p(src), self._p(dst), flags)
                    return ("r2", st)
                os.rename(self._p(src), self._p(dst))
                return (0,)
            if kind == "chmod":
                os.chmod(self._p(op[1]), op[2])
                return (0, os.stat(self._p(op[1])).st_mode & 0o7777)
            if kind == "setxattr":
                os.setxattr(self._p(op[1]), op[2], op[3])
                return (0, os.getxattr(self._p(op[1]), op[2]))
            if kind == "removexattr":
                os.removexattr(self._p(op[1]), op[2])
                return (0,)
            if kind == "listxattr":
                return (0, tuple(sorted(os.listxattr(self._p(op[1])))))
            if kind == "stat":
                st = os.stat(self._p(op[1]), follow_symlinks=False)
                import stat as _s

                return (0, _s.S_IFMT(st.st_mode), st.st_mode & 0o7777,
                        st.st_size if not _s.S_ISDIR(st.st_mode) else None,
                        st.st_nlink if not _s.S_ISDIR(st.st_mode) else None)
            if kind == "readdir":
                return (0, tuple(sorted(os.listdir(self._p(op[1])))))
            raise AssertionError(kind)
        except OSError as e:
            return ("E", e.errno)

    def tree(self) -> dict:
        """Canonical final state (structure, perms, content, xattrs).

        Walks with listdir + full-path lstat, NOT os.walk/scandir: this
        kernel emulation deadlocks on scandir's dirfd-relative following
        stat (DirEntry.is_dir) when the entry is a symlink, before any
        FUSE request is issued.  Full-path syscalls resolve fine, and
        lstat is the right classifier anyway (symlinked dirs must not be
        descended)."""
        out = {}
        import stat as _s

        pending = ["."]
        while pending:
            rel = pending.pop()
            dirp = self.root if rel == "." else os.path.join(self.root, rel)
            for name in sorted(os.listdir(dirp)):
                p = os.path.join(dirp, name)
                key = os.path.normpath(os.path.join(rel, name))
                st = os.stat(p, follow_symlinks=False)
                if _s.S_ISDIR(st.st_mode):
                    pending.append(key)
                node = {"fmt": _s.S_IFMT(st.st_mode),
                        "mode": st.st_mode & 0o7777}
                if _s.S_ISLNK(st.st_mode):
                    node["target"] = os.readlink(p)
                elif _s.S_ISREG(st.st_mode):
                    node["size"] = st.st_size
                    node["nlink"] = st.st_nlink
                    with open(p, "rb") as f:
                        try:
                            os.posix_fadvise(f.fileno(), 0, 0,
                                             os.POSIX_FADV_DONTNEED)
                        except OSError:
                            pass
                        node["sha"] = hashlib.sha256(f.read()).hexdigest()
                try:
                    node["xattrs"] = {
                        k: os.getxattr(p, k, follow_symlinks=False)
                        for k in os.listxattr(p, follow_symlinks=False)
                        if k.startswith("user.")
                    }
                except OSError:
                    node["xattrs"] = {}
                out[key] = node
        return out


class OpGen:
    """Stateful op generator (hypothesis-RuleBasedStateMachine analog,
    reference .github/scripts/hypo/fs.py): peeks at the ORACLE's live tree
    to bias targets toward paths that exist, so most ops exercise real
    semantics instead of returning ENOENT. Deterministic given the seed
    because the oracle state is itself a pure function of the op stream."""

    def __init__(self, seed: int, oracle_root: str, with_xattr: bool,
                 with_rename_flags: bool = True):
        self.rng = random.Random(seed)
        self.root = oracle_root
        self.rename_flags = with_rename_flags
        kinds = ["mkdir", "create", "create", "write", "write", "append",
                 "read", "read", "open_slot", "slot_write", "slot_truncate",
                 "slot_close", "truncate", "shrinkgrow", "shrinkgrow",
                 "unlink", "rmdir", "symlink", "readlink", "link", "rename",
                 "rename", "chmod", "stat", "readdir"]
        if with_xattr:
            kinds += ["setxattr", "setxattr", "removexattr", "listxattr"]
        self.kinds = kinds

    def _scan(self) -> tuple[list[str], list[str]]:
        dirs, files = ["."], []
        for dirpath, dirnames, filenames in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            dirs.extend(os.path.normpath(os.path.join(rel, d)) for d in dirnames)
            files.extend(os.path.normpath(os.path.join(rel, f)) for f in filenames)
        return sorted(dirs), sorted(files)

    def _target(self, files, dirs, p_existing=0.75) -> str:
        rng = self.rng
        if files and rng.random() < p_existing:
            return rng.choice(files)
        return os.path.normpath(
            os.path.join(rng.choice(dirs), rng.choice(NAMES))
        )

    def next_op(self) -> tuple:
        rng = self.rng
        dirs, files = self._scan()
        kind = rng.choice(self.kinds)
        rel = self._target(files, dirs)
        if kind == "mkdir":
            return ("mkdir",
                    os.path.normpath(os.path.join(rng.choice(dirs), rng.choice(NAMES))),
                    rng.choice([0o755, 0o750]))
        if kind == "create":
            return ("create",
                    os.path.normpath(os.path.join(rng.choice(dirs), rng.choice(NAMES))),
                    rng.choice([0o644, 0o600, 0o640]))
        if kind == "write":
            return ("write", rel, rng.randrange(0, 1 << 16),
                    rng.randbytes(rng.randrange(1, 1 << 12)))
        if kind == "append":
            return ("append", rel, rng.randbytes(rng.randrange(1, 4096)))
        if kind == "read":
            return ("read", rel, rng.randrange(0, 1 << 16),
                    rng.randrange(1, 1 << 14))
        if kind == "open_slot":
            flags = rng.choice([os.O_RDWR, os.O_WRONLY,
                                os.O_WRONLY | os.O_APPEND])
            return ("open_slot", rng.randrange(4), rel, flags)
        if kind == "slot_write":
            return ("slot_write", rng.randrange(4),
                    rng.randbytes(rng.randrange(1, 4096)))
        if kind == "slot_truncate":
            return ("slot_truncate", rng.randrange(4), rng.randrange(0, 1 << 15))
        if kind == "slot_close":
            return ("slot_close", rng.randrange(4))
        if kind == "truncate":
            return ("truncate", rel, rng.randrange(0, 1 << 16))
        if kind == "shrinkgrow":
            small = rng.randrange(0, 1 << 13)
            return ("shrinkgrow", rel, small, small + rng.randrange(1, 1 << 15))
        if kind in ("unlink", "readlink", "stat"):
            return (kind, rel)
        if kind == "rmdir":
            return ("rmdir", rng.choice(dirs[1:]) if len(dirs) > 1 and
                    rng.random() < 0.7 else rel)
        if kind == "symlink":
            return ("symlink",
                    os.path.normpath(os.path.join(rng.choice(dirs), rng.choice(NAMES))),
                    "../" + rng.choice(NAMES))
        if kind == "link":
            # never hardlink a directory: Linux's vfs_link reports EEXIST
            # for an existing destination before the EPERM-for-dirs check,
            # this emulated kernel does the opposite — an ordering the
            # oracle cannot reconcile (the request never reaches the fs)
            if os.path.isdir(os.path.join(self.root, rel)):
                rel = rng.choice(files) if files else "nonexistent-link-src"
            return ("link", rel,
                    os.path.normpath(os.path.join(rng.choice(dirs), rng.choice(NAMES))))
        if kind == "rename":
            flags = rng.choice([0, 0, 0, RENAME_NOREPLACE, RENAME_EXCHANGE])
            if not self.rename_flags:
                flags = 0
            # destination is an existing path half the time so replace /
            # exchange semantics actually run
            dst = self._target(files, dirs, p_existing=0.5)
            return ("rename", rel, dst, flags)
        if kind == "chmod":
            return ("chmod", rel, rng.choice([0o600, 0o640, 0o777, 0o444]))
        if kind == "setxattr":
            return ("setxattr", rel, rng.choice(XKEYS),
                    rng.randbytes(rng.randrange(1, 32)))
        if kind == "removexattr":
            return ("removexattr", rel, rng.choice(XKEYS))
        if kind == "listxattr":
            return ("listxattr", rel)
        if kind == "readdir":
            return ("readdir", rng.choice(dirs))
        raise AssertionError(kind)


@pytest.fixture(params=["mem", "sql"])
def mounted(tmp_path, request):
    """Run the oracle over BOTH engine families: the KV engine (mem://)
    and the relational engine (sql://) — kernel-level semantic
    validation for each independent implementation."""
    from torch_fuse_mount import fuse_mount

    meta_url = ("mem://" if request.param == "mem"
                else f"sql://{tmp_path}/oracle-rel.db")
    from juicefs_tpu_torch.vfs import VFSConfig

    # TTL 0: every stat/lookup revalidates against the server.  The oracle
    # must observe the filesystem's OWN semantics; this kernel does not
    # alias hardlinked paths to one inode, so any nonzero attr TTL lets it
    # serve stale nlink/size on the sibling name and fail the comparison
    # on kernel-cache artifacts rather than real bugs.
    conf = VFSConfig(attr_timeout=0.0, entry_timeout=0.0,
                     dir_entry_timeout=0.0)
    with fuse_mount(tmp_path, name="oracle", trash_days=0,
                    meta_url=meta_url, vfs_conf=conf) as mp:
        yield mp


@pytest.mark.parametrize("seed", [11, 4242, 90210])
def test_mount_matches_kernel_oracle(mounted, tmp_path, seed):
    scratch = tmp_path / "oracle"
    scratch.mkdir()
    with_xattr = _xattr_supported(str(scratch)) and _xattr_supported(mounted)
    with_flags = (_renameat2_flags_supported(str(scratch))
                  and _renameat2_flags_supported(mounted))
    gen = OpGen(seed, str(scratch), with_xattr, with_flags)
    fs_a = FsDriver(mounted)          # the system under test
    fs_b = FsDriver(str(scratch))     # the kernel's own fs: ground truth
    n_ok = 0
    try:
        for i in range(1100):
            op = gen.next_op()
            ra = fs_a.apply(op)
            rb = fs_b.apply(op)
            assert ra == rb, (
                f"seed {seed} step {i} {op[0]}{op[1:3]}: mount={ra!r} "
                f"oracle={rb!r}"
            )
            if ra[0] == 0:
                n_ok += 1
    finally:
        fs_a.close_all()
        fs_b.close_all()
    assert n_ok > 500, f"too few successful ops ({n_ok}) — generator degraded"
    ta = fs_a.tree()
    tb = fs_b.tree()
    assert ta == tb, f"final tree diverged (seed {seed})"
    assert ta, "random sequence produced an empty tree"
