"""The port's libjfs C shim and its builder.

`libjfs.cpp` embeds CPython and trampolines every `jfs_*` call of `jfs.h`
(the reference's C ABI, declaration for declaration) into
`juicefs_tpu_torch.sdk`. Nothing is built when this module is imported:
`build()` compiles the shim with g++ against the running interpreter
(`sysconfig`'s INCLUDEPY, LIBDIR, LDLIBRARY) into `<repo>/build/sdk_c/`
at first use, and `build_program(src)` compiles a C consumer against the
port's `jfs.h` (never a `jfs.h` beside the consumer's source) and that
library. A failed build raises.

A consumer runs in `child_env()`: the embedded interpreter finds its
prefix through the first `python3` on PATH, so the running interpreter's
directory goes first on PATH (the rest stays), and PYTHONPATH names the
repo and the running interpreter's site-packages, so that
`juicefs_tpu_torch`, torch and numpy import inside the consumer.

    python -c "from juicefs_tpu_torch import sdk_c; print(sdk_c.build())"
"""

from __future__ import annotations

import hashlib
import os
import shutil
import site
import subprocess
import sys
import sysconfig
import threading

SDK_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(SDK_DIR))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "sdk_c")
HEADER = os.path.join(SDK_DIR, "jfs.h")
SHIM = os.path.join(SDK_DIR, "libjfs.cpp")
JFS_COPY = os.path.join(SDK_DIR, "jfs_copy.c")

_lock = threading.Lock()


def embed_flags() -> tuple[list[str], list[str]]:
    """(compile flags, link flags) that embed the running interpreter.
    Raises when its Python.h or its shared libpython is missing."""
    cfg = sysconfig.get_config_var
    include, libdir, ldlib = cfg("INCLUDEPY"), cfg("LIBDIR"), cfg("LDLIBRARY")
    if not include or not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(f"Python.h not found under {include!r}: the interpreter "
                           f"{sys.executable} has no development headers")
    if not libdir or not ldlib or not os.path.exists(os.path.join(libdir, ldlib)) \
            or not ldlib.endswith(".so"):
        raise RuntimeError(f"shared libpython not found ({libdir!r}/{ldlib!r}): the "
                           f"interpreter {sys.executable} cannot be embedded")
    lib = "python" + cfg("VERSION") + (getattr(sys, "abiflags", "") or "")
    libs = f"{cfg('LIBS') or ''} {cfg('SYSLIBS') or ''}".split()
    return [f"-I{include}"], [f"-L{libdir}", f"-l{lib}", *libs, f"-Wl,-rpath,{libdir}"]


def _tool(name: str) -> str:
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(f"{name} not found on PATH")
    return path


def _run(argv: list[str], what: str) -> None:
    proc = subprocess.run(argv, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed (rc {proc.returncode}): {' '.join(argv)}\n"
                           f"{proc.stdout}{proc.stderr}")


def _digest(*parts: str) -> str:
    h = hashlib.sha256()
    for part in parts:
        h.update(part.encode())
        if os.path.exists(part):
            with open(part, "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build(out_dir: str | None = None) -> str:
    """Build (once per source and interpreter) the port's libjfs.so and
    return its path. It lands in `out_dir/<digest>/` (default
    `<repo>/build/sdk_c/`), so an edited source is rebuilt."""
    cflags, ldflags = embed_flags()
    tag = _digest(SHIM, HEADER, sys.executable, *cflags, *ldflags)
    lib_dir = os.path.join(out_dir or BUILD_DIR, tag)
    so = os.path.join(lib_dir, "libjfs.so")
    with _lock:
        if not os.path.exists(so):
            os.makedirs(lib_dir, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            _run([_tool("g++"), "-shared", "-fPIC", "-O2", "-Wl,-soname,libjfs.so",
                  f"-I{SDK_DIR}", *cflags, "-o", tmp, SHIM, *ldflags], "g++ (libjfs)")
            os.replace(tmp, so)
    return so


def build_program(source: str, out_dir: str | None = None) -> str:
    """Compile the C consumer `source` against the port's jfs.h and
    libjfs.so (built first if needed); returns the executable's path,
    `<stem>-<digest of the source>` beside the library. The source is
    copied beside the library first: a `#include "jfs.h"` searches the
    including file's own directory before any -I, and the header found
    must be the port's, not one that sits beside the source."""
    so = build(out_dir)
    lib_dir = os.path.dirname(so)
    stem = os.path.splitext(os.path.basename(source))[0]
    exe = os.path.join(lib_dir, f"{stem}-{_digest(source)}")
    with _lock:
        if not os.path.exists(exe):
            tmp = f"{exe}.{os.getpid()}.tmp"
            src = f"{tmp}.c"
            shutil.copyfile(source, src)
            try:
                _run([_tool("gcc"), "-O2", "-o", tmp, src, f"-I{SDK_DIR}", so,
                      f"-Wl,-rpath,{lib_dir}"], f"gcc ({os.path.basename(source)})")
            finally:
                os.unlink(src)
            os.replace(tmp, exe)
    return exe


def child_env(env: dict | None = None) -> dict:
    """The environment a consumer of the shim runs in: `env` (default this
    process's) with the running interpreter's directory first on PATH and
    PYTHONPATH set to the repo and that interpreter's site-packages."""
    out = dict(os.environ if env is None else env)
    out["PATH"] = os.pathsep.join([os.path.dirname(sys.executable)]
                                  + [p for p in [out.get("PATH")] if p])
    paths = [REPO_ROOT, *site.getsitepackages()]
    if out.get("PYTHONPATH"):
        paths.append(out["PYTHONPATH"])
    out["PYTHONPATH"] = os.pathsep.join(paths)
    return out
