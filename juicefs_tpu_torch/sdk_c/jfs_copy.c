/* jfs_copy: copy a host file into a volume through the libjfs C ABI and
 * read it back.
 *
 *     jfs_copy META_URL HOST_FILE VOL_PATH [piece_bytes]
 *
 * Writes HOST_FILE to VOL_PATH with jfs_pwrite in pieces (1 MiB unless
 * piece_bytes says otherwise), then jfs_flush and jfs_close; reopens the
 * file, reads it back with jfs_pread in the same pieces and compares each
 * with the host file; last, jfs_term (which drains the volume's block
 * indexer). Prints one JSON line:
 *
 *     {"bytes": N, "pieces": P, "write_seconds": W, "read_seconds": R,
 *      "term_seconds": T, "mismatches": M}
 *
 * write_seconds covers the writes, the flush and the close; read_seconds
 * the reopen and the reads; mismatches counts pieces read back short or
 * different. Exits 0 only when every call succeeded and M is 0. It calls
 * nothing but the functions of jfs.h: test tooling for the ABI, as
 * sdk/c/example.c is. */

#include <fcntl.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "jfs.h"

static double now(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

static int fail(const char *what, long long rc) {
    fprintf(stderr, "jfs_copy: %s failed: %lld\n", what, rc);
    return 1;
}

int main(int argc, char **argv) {
    if (argc < 4 || argc > 5) {
        fprintf(stderr, "usage: %s META_URL HOST_FILE VOL_PATH [piece_bytes]\n", argv[0]);
        return 2;
    }
    long long piece = argc == 5 ? atoll(argv[4]) : (1LL << 20);
    if (piece <= 0) {
        fprintf(stderr, "jfs_copy: piece_bytes must be > 0\n");
        return 2;
    }
    FILE *host = fopen(argv[2], "rb");
    if (host == NULL) {
        perror(argv[2]);
        return 1;
    }
    char *buf = malloc((size_t)piece);
    char *back = malloc((size_t)piece);
    if (buf == NULL || back == NULL) {
        fprintf(stderr, "jfs_copy: out of memory\n");
        return 1;
    }

    int64_t mid = jfs_init(argv[1]);
    if (mid <= 0) return fail("jfs_init", mid);

    int64_t fd = jfs_open(mid, argv[3], O_CREAT | O_WRONLY, 0644);
    if (fd <= 0) return fail("jfs_open (create)", fd);
    long long total = 0, pieces = 0;
    double t0 = now();
    for (;;) {
        size_t n = fread(buf, 1, (size_t)piece, host);
        if (n == 0) break;
        int64_t w = jfs_pwrite(mid, fd, buf, n, total);
        if (w != (int64_t)n) return fail("jfs_pwrite", w);
        total += (long long)n;
        pieces++;
    }
    if (ferror(host)) {
        perror(argv[2]);
        return 1;
    }
    int rc = jfs_flush(mid, fd);
    if (rc != 0) return fail("jfs_flush", rc);
    rc = jfs_close(mid, fd);
    if (rc != 0) return fail("jfs_close", rc);
    double write_s = now() - t0;

    long long mismatches = 0;
    t0 = now();
    fd = jfs_open(mid, argv[3], O_RDONLY, 0);
    if (fd <= 0) return fail("jfs_open (reopen)", fd);
    rewind(host);
    for (long long off = 0; off < total; off += piece) {
        size_t want = fread(buf, 1, (size_t)piece, host);
        int64_t got = jfs_pread(mid, fd, back, want, off);
        if (got < 0) return fail("jfs_pread", got);
        if (got != (int64_t)want || memcmp(buf, back, want) != 0) mismatches++;
    }
    rc = jfs_close(mid, fd);
    if (rc != 0) return fail("jfs_close (reopen)", rc);
    double read_s = now() - t0;

    t0 = now();
    rc = jfs_term(mid);
    if (rc != 0) return fail("jfs_term", rc);
    double term_s = now() - t0;
    fclose(host);
    free(buf);
    free(back);

    printf("{\"bytes\": %lld, \"pieces\": %lld, \"write_seconds\": %.6f, "
           "\"read_seconds\": %.6f, \"term_seconds\": %.6f, \"mismatches\": %lld}\n",
           total, pieces, write_s, read_s, term_s, mismatches);
    return mismatches == 0 ? 0 : 1;
}
