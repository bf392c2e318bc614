"""POSIX ACL rules (reference pkg/acl/acl.go, 256 LoC).

A Rule carries the extended permission set of one inode: owner/group/
other/mask class bits plus named user/group entries. Rules are interned
in the meta engine by id (`R{id}` keys, insert-only) and inodes point at
them via Attr.access_acl / Attr.default_acl (reference pkg/acl/cache.go
id-interning; tkv.go insertACL/getACL).

The Linux xattr wire format (system.posix_acl_access/default payloads,
reference pkg/vfs/vfs.go:1334-1420 encodeACL/decodeACL) lives here too as
to_xattr/from_xattr so every adapter shares one codec.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

UNDEF = 0xFFFF  # "class not set" marker (reference acl.go EmptyRule)
ACL_NONE = 0  # Attr acl-id meaning "no ACL"

TYPE_ACCESS = 1
TYPE_DEFAULT = 2

# Linux posix_acl_xattr tags (reference vfs.go:1334-1347 comment)
_TAG_USER_OBJ = 0x01
_TAG_USER = 0x02
_TAG_GROUP_OBJ = 0x04
_TAG_GROUP = 0x08
_TAG_MASK = 0x10
_TAG_OTHER = 0x20

XATTR_VERSION = 2


@dataclass
class Rule:
    """reference acl.go Rule; perms are 3-bit rwx values."""

    owner: int = UNDEF
    group: int = UNDEF
    mask: int = UNDEF
    other: int = UNDEF
    named_users: tuple[tuple[int, int], ...] = ()   # ((id, perm), ...)
    named_groups: tuple[tuple[int, int], ...] = ()

    # -- storage codec (big-endian, engine-portable) -----------------------
    def encode(self) -> bytes:
        out = [struct.pack(">HHHH", self.owner, self.group, self.mask, self.other)]
        out.append(struct.pack(">I", len(self.named_users)))
        for uid, perm in self.named_users:
            out.append(struct.pack(">IH", uid, perm))
        out.append(struct.pack(">I", len(self.named_groups)))
        for gid, perm in self.named_groups:
            out.append(struct.pack(">IH", gid, perm))
        return b"".join(out)

    @classmethod
    def decode(cls, data: bytes) -> "Rule":
        owner, group, mask, other = struct.unpack_from(">HHHH", data, 0)
        off = 8
        (nu,) = struct.unpack_from(">I", data, off)
        off += 4
        users = []
        for _ in range(nu):
            uid, perm = struct.unpack_from(">IH", data, off)
            users.append((uid, perm))
            off += 6
        (ng,) = struct.unpack_from(">I", data, off)
        off += 4
        groups = []
        for _ in range(ng):
            gid, perm = struct.unpack_from(">IH", data, off)
            groups.append((gid, perm))
            off += 6
        return cls(owner, group, mask, other, tuple(users), tuple(groups))

    # -- predicates (reference acl.go:134-151) -----------------------------
    def is_empty(self) -> bool:
        return (
            not self.named_users and not self.named_groups
            and self.owner & self.group & self.other & self.mask == UNDEF
        )

    def is_minimal(self) -> bool:
        """Equivalent to a plain mode (no extended entries, no mask)."""
        return not self.named_users and not self.named_groups and self.mask == UNDEF

    # -- mode interplay (reference acl.go:163-196) -------------------------
    def inherit_perms(self, mode: int) -> None:
        if self.owner == UNDEF:
            self.owner = (mode >> 6) & 7
        if self.group == UNDEF:
            self.group = (mode >> 3) & 7
        if self.other == UNDEF:
            self.other = mode & 7

    def set_mode(self, mode: int) -> None:
        """chmod with an ACL present: group class bits land in the mask."""
        self.owner = (self.owner & 0xFFF8) | ((mode >> 6) & 7)
        if self.is_minimal():
            self.group = (self.group & 0xFFF8) | ((mode >> 3) & 7)
        else:
            self.mask = (self.mask & 0xFFF8) | ((mode >> 3) & 7)
        self.other = (self.other & 0xFFF8) | (mode & 7)

    def get_mode(self) -> int:
        if self.is_minimal():
            return ((self.owner & 7) << 6) | ((self.group & 7) << 3) | (self.other & 7)
        return ((self.owner & 7) << 6) | ((self.mask & 7) << 3) | (self.other & 7)

    def child_access_acl(self, mode: int) -> "Rule":
        """Access ACL a new child gets from this default ACL
        (reference acl.go:199-210 ChildAccessACL)."""
        return Rule(
            owner=(mode >> 6) & 7 & self.owner,
            group=self.group,
            mask=(mode >> 3) & 7 & self.mask,
            other=mode & 7 & self.other,
            named_users=self.named_users,
            named_groups=self.named_groups,
        )

    # -- permission evaluation (reference acl.go:217-247 CanAccess) --------
    def can_access(self, uid: int, gids, fuid: int, fgid: int, mask: int) -> bool:
        if uid == fuid:
            return (self.owner & 7) & mask == mask
        for nuid, perm in self.named_users:
            if uid == nuid:
                return (perm & self.mask & 7) & mask == mask
        grp_matched = False
        for gid in gids:
            if gid == fgid:
                if (self.group & self.mask & 7) & mask == mask:
                    return True
                grp_matched = True
        for gid in gids:
            for ngid, perm in self.named_groups:
                if gid == ngid:
                    if (perm & self.mask & 7) & mask == mask:
                        return True
                    grp_matched = True
        if grp_matched:
            return False
        return (self.other & 7) & mask == mask


def empty_rule() -> Rule:
    return Rule()


# -- Linux xattr payload codec (reference vfs.go:1348-1420) ---------------
# little-endian per the kernel's posix_acl_xattr layout:
#   version:32le, then entries of (tag:16le, perm:16le, id:32le)

def to_xattr(rule: Rule) -> bytes:
    out = [struct.pack("<I", XATTR_VERSION)]

    def ent(tag: int, perm: int, eid: int = 0xFFFFFFFF):
        out.append(struct.pack("<HHI", tag, perm, eid))

    ent(_TAG_USER_OBJ, rule.owner)
    for uid, perm in rule.named_users:
        ent(_TAG_USER, perm, uid)
    ent(_TAG_GROUP_OBJ, rule.group)
    for gid, perm in rule.named_groups:
        ent(_TAG_GROUP, perm, gid)
    if rule.mask != UNDEF:
        ent(_TAG_MASK, rule.mask)
    ent(_TAG_OTHER, rule.other)
    return b"".join(out)


def from_xattr(buf: bytes) -> Rule | None:
    """Decode a kernel ACL xattr payload; None on malformed input
    (reference decodeACL returns EINVAL)."""
    if len(buf) < 4 or (len(buf) % 8) != 4:
        return None
    (version,) = struct.unpack_from("<I", buf, 0)
    if version != XATTR_VERSION:
        return None
    rule = Rule()
    users, groups = [], []
    for off in range(4, len(buf), 8):
        tag, perm, eid = struct.unpack_from("<HHI", buf, off)
        if tag == _TAG_USER_OBJ:
            if rule.owner != UNDEF:
                return None
            rule.owner = perm
        elif tag == _TAG_USER:
            users.append((eid, perm))
        elif tag == _TAG_GROUP_OBJ:
            if rule.group != UNDEF:
                return None
            rule.group = perm
        elif tag == _TAG_GROUP:
            groups.append((eid, perm))
        elif tag == _TAG_MASK:
            if rule.mask != UNDEF:
                return None
            rule.mask = perm
        elif tag == _TAG_OTHER:
            if rule.other != UNDEF:
                return None
            rule.other = perm
        else:
            return None
    rule.named_users = tuple(users)
    rule.named_groups = tuple(groups)
    if rule.mask == UNDEF and (rule.named_users or rule.named_groups):
        return None  # extended entries require a mask (kernel invariant)
    return rule
