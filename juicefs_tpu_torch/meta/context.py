"""Operation context: caller identity for permission checks
(reference: pkg/meta/context.go Context/uid/gid plumbing)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Context:
    uid: int = 0
    gid: int = 0
    gids: tuple[int, ...] = (0,)
    pid: int = 0
    check_permission: bool = True

    def contains_gid(self, gid: int) -> bool:
        return gid == self.gid or gid in self.gids


BACKGROUND = Context(uid=0, gid=0, gids=(0,), pid=0, check_permission=False)
