/* libjfs C ABI (role-match to the reference's Go c-shared libjfs,
 * sdk/java/libjfs/main.go:409-900): language-neutral bindings over the
 * juicefs_tpu_torch filesystem. Every call returns >= 0 on success, -errno on
 * failure. Thread-safe: calls may come from any thread.
 *
 * The library embeds a CPython interpreter; `juicefs_tpu_torch` must be
 * importable (set PYTHONPATH or install the package). The declarations
 * are those of sdk/c/jfs.h, so the ABI is the same. */

#ifndef JFS_H
#define JFS_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

struct jfs_stat {
    int64_t size;
    int32_t mode;   /* type bits | permissions, st_mode layout */
    int32_t uid;
    int32_t gid;
    int64_t atime;
    int64_t mtime;
    int64_t ctime;
    int32_t nlink;
};

int jfs_sdk_version(void);

/* mounts */
int64_t jfs_init(const char *meta_url);                /* -> mount id   */
int     jfs_term(int64_t mid);

/* files */
int64_t jfs_open(int64_t mid, const char *path, int flags, int mode);
int     jfs_close(int64_t mid, int64_t fd);
int64_t jfs_pread(int64_t mid, int64_t fd, void *buf, uint64_t n, int64_t off);
int64_t jfs_pwrite(int64_t mid, int64_t fd, const void *buf, uint64_t n,
                   int64_t off);
int     jfs_flush(int64_t mid, int64_t fd);

/* namespace */
int jfs_mkdir(int64_t mid, const char *path, int mode);
int jfs_rmdir(int64_t mid, const char *path);
int jfs_unlink(int64_t mid, const char *path);
int jfs_rename(int64_t mid, const char *src, const char *dst);
int jfs_truncate(int64_t mid, const char *path, int64_t length);
int jfs_stat(int64_t mid, const char *path, struct jfs_stat *out);

/* Directory listing: writes newline-separated names into buf (NUL
 * terminated); returns the full required size (call again with a bigger
 * buffer if the return value >= bufsize), or -errno. */
int64_t jfs_listdir(int64_t mid, const char *path, char *buf,
                    uint64_t bufsize);

/* statvfs: totalbytes/availbytes/usedinodes/availinodes */
int jfs_statvfs(int64_t mid, int64_t out[4]);

#ifdef __cplusplus
}
#endif

#endif /* JFS_H */
