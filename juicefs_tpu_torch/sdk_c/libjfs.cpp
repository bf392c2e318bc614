/* libjfs: C ABI over the juicefs_tpu_torch filesystem by embedding CPython.
 *
 * The port's copy of the C shim, with the same ABI (jfs.h): a thin
 * trampoline into juicefs_tpu_torch/sdk.py, which owns all marshalling and
 * the mount/file registries (role-match to the reference's Go c-shared
 * libjfs, sdk/java/libjfs/main.go:409-900). A volume formatted with a
 * device hash backend hashes its blocks on the card inside the embedded
 * interpreter. Built by juicefs_tpu_torch/sdk_c/__init__.py build();
 * consumers: any C/C++ program (jfs_copy.c beside this file), or a JNA
 * binding of libjfs by name.
 */

#include "jfs.h"

#define PY_SSIZE_T_CLEAN  /* y#/s# take Py_ssize_t lengths */
#include <Python.h>

#include <cerrno>
#include <cstring>
#include <mutex>

namespace {

std::once_flag g_init_once;
PyObject *g_mod = nullptr;  // juicefs_tpu_torch.sdk

void init_python() {
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);  // no signal handlers: we are a guest
#if PY_VERSION_HEX < 0x030900f0
        PyEval_InitThreads();
#endif
        // release the GIL acquired by Py_Initialize so any thread can
        // enter via PyGILState_Ensure
        PyEval_SaveThread();
    }
    PyGILState_STATE st = PyGILState_Ensure();
    g_mod = PyImport_ImportModule("juicefs_tpu_torch.sdk");
    if (g_mod == nullptr) {
        PyErr_Print();
    }
    PyGILState_Release(st);
}

struct Gil {
    PyGILState_STATE st;
    Gil() { st = PyGILState_Ensure(); }
    ~Gil() { PyGILState_Release(st); }
};

// Call sdk.<name>(*args) -> new reference (nullptr on python exception).
PyObject *call(const char *name, PyObject *args) {
    if (g_mod == nullptr) {
        Py_XDECREF(args);
        return nullptr;
    }
    PyObject *fn = PyObject_GetAttrString(g_mod, name);
    if (fn == nullptr) {
        Py_XDECREF(args);
        return nullptr;
    }
    PyObject *out = PyObject_CallObject(fn, args);
    Py_DECREF(fn);
    Py_XDECREF(args);
    if (out == nullptr) {
        PyErr_Print();
    }
    return out;
}

int64_t call_i64(const char *name, PyObject *args) {
    PyObject *out = call(name, args);
    if (out == nullptr) {
        return -EIO;
    }
    int64_t v = PyLong_AsLongLong(out);
    Py_DECREF(out);
    if (PyErr_Occurred()) {
        PyErr_Clear();
        return -EIO;
    }
    return v;
}

}  // namespace

extern "C" {

int jfs_sdk_version(void) { return 1; }

int64_t jfs_init(const char *meta_url) {
    std::call_once(g_init_once, init_python);
    Gil gil;
    return call_i64("jfs_init", Py_BuildValue("(s)", meta_url));
}

int jfs_term(int64_t mid) {
    Gil gil;
    return (int)call_i64("jfs_term", Py_BuildValue("(L)", mid));
}

int64_t jfs_open(int64_t mid, const char *path, int flags, int mode) {
    Gil gil;
    return call_i64("jfs_open", Py_BuildValue("(Lsii)", mid, path, flags, mode));
}

int jfs_close(int64_t mid, int64_t fd) {
    Gil gil;
    return (int)call_i64("jfs_close", Py_BuildValue("(LL)", mid, fd));
}

int64_t jfs_pread(int64_t mid, int64_t fd, void *buf, uint64_t n, int64_t off) {
    Gil gil;
    PyObject *out = call(
        "jfs_pread", Py_BuildValue("(LLLK)", mid, fd, off, (unsigned long long)n));
    if (out == nullptr) {
        return -EIO;
    }
    if (PyLong_Check(out)) {  // -errno
        int64_t v = PyLong_AsLongLong(out);
        Py_DECREF(out);
        return v;
    }
    char *data = nullptr;
    Py_ssize_t len = 0;
    if (PyBytes_AsStringAndSize(out, &data, &len) != 0) {
        Py_DECREF(out);
        PyErr_Clear();
        return -EIO;
    }
    if ((uint64_t)len > n) {
        len = (Py_ssize_t)n;
    }
    memcpy(buf, data, (size_t)len);
    Py_DECREF(out);
    return (int64_t)len;
}

int64_t jfs_pwrite(int64_t mid, int64_t fd, const void *buf, uint64_t n,
                   int64_t off) {
    Gil gil;
    return call_i64(
        "jfs_pwrite",
        Py_BuildValue("(LLLy#)", mid, fd, off, (const char *)buf, (Py_ssize_t)n));
}

int jfs_flush(int64_t mid, int64_t fd) {
    Gil gil;
    return (int)call_i64("jfs_flush", Py_BuildValue("(LL)", mid, fd));
}

int jfs_mkdir(int64_t mid, const char *path, int mode) {
    Gil gil;
    return (int)call_i64("jfs_mkdir", Py_BuildValue("(Lsi)", mid, path, mode));
}

int jfs_rmdir(int64_t mid, const char *path) {
    Gil gil;
    return (int)call_i64("jfs_rmdir", Py_BuildValue("(Ls)", mid, path));
}

int jfs_unlink(int64_t mid, const char *path) {
    Gil gil;
    return (int)call_i64("jfs_unlink", Py_BuildValue("(Ls)", mid, path));
}

int jfs_rename(int64_t mid, const char *src, const char *dst) {
    Gil gil;
    return (int)call_i64("jfs_rename", Py_BuildValue("(Lss)", mid, src, dst));
}

int jfs_truncate(int64_t mid, const char *path, int64_t length) {
    Gil gil;
    return (int)call_i64("jfs_truncate", Py_BuildValue("(LsL)", mid, path, length));
}

int jfs_stat(int64_t mid, const char *path, struct jfs_stat *out) {
    Gil gil;
    PyObject *res = call("jfs_stat", Py_BuildValue("(Ls)", mid, path));
    if (res == nullptr) {
        return -EIO;
    }
    if (PyLong_Check(res)) {
        int v = (int)PyLong_AsLong(res);
        Py_DECREF(res);
        return v;
    }
    long long size, atime, mtime, ctime;
    int mode, uid, gid, nlink;
    if (!PyArg_ParseTuple(res, "LiiiLLLi", &size, &mode, &uid, &gid, &atime,
                          &mtime, &ctime, &nlink)) {
        Py_DECREF(res);
        PyErr_Clear();
        return -EIO;
    }
    Py_DECREF(res);
    out->size = size;
    out->mode = mode;
    out->uid = uid;
    out->gid = gid;
    out->atime = atime;
    out->mtime = mtime;
    out->ctime = ctime;
    out->nlink = nlink;
    return 0;
}

int64_t jfs_listdir(int64_t mid, const char *path, char *buf, uint64_t bufsize) {
    Gil gil;
    PyObject *res = call("jfs_listdir", Py_BuildValue("(Ls)", mid, path));
    if (res == nullptr) {
        return -EIO;
    }
    if (PyLong_Check(res)) {
        int64_t v = PyLong_AsLongLong(res);
        Py_DECREF(res);
        return v;
    }
    Py_ssize_t len = 0;
    const char *s = PyUnicode_AsUTF8AndSize(res, &len);
    if (s == nullptr) {
        Py_DECREF(res);
        PyErr_Clear();
        return -EIO;
    }
    if (bufsize > 0) {
        size_t ncopy = (uint64_t)len < bufsize - 1 ? (size_t)len : bufsize - 1;
        memcpy(buf, s, ncopy);
        buf[ncopy] = '\0';
    }
    Py_DECREF(res);
    return (int64_t)len + 1;  // required size incl. NUL
}

int jfs_statvfs(int64_t mid, int64_t out[4]) {
    Gil gil;
    PyObject *res = call("jfs_statvfs", Py_BuildValue("(L)", mid));
    if (res == nullptr) {
        return -EIO;
    }
    if (PyLong_Check(res)) {
        int v = (int)PyLong_AsLong(res);
        Py_DECREF(res);
        return v;
    }
    long long a, b, c, d;
    if (!PyArg_ParseTuple(res, "LLLL", &a, &b, &c, &d)) {
        Py_DECREF(res);
        PyErr_Clear();
        return -EIO;
    }
    Py_DECREF(res);
    out[0] = a;
    out[1] = b;
    out[2] = c;
    out[3] = d;
    return 0;
}

}  // extern "C"
