/* dmfeat: the native featurizer of the PyTorch port.
 *
 * The port's own copy of the featurize part of native/matchkern/dmkern.c
 * (its lines 1-584 and its utf8_valid), with the same semantics; the
 * template matcher, the parser rows, the NewValueDetector scan and the shm
 * refcounts of that file are not here. Exposed to Python through ctypes
 * (detectmateservice_tpu_torch/utils/matchkern.py), which builds this file
 * with the host C compiler at its first call.
 *
 * Kernels:
 *   dm_featurize_batch - serialized ParserSchema bytes -> token-id rows.
 *     Parses the protobuf wire format directly (fields: template=5,
 *     variables=6, logFormatVariables=10 map<str,str>), tokenizes on
 *     non-alphanumeric boundaries, lowercases, and hashes tokens with
 *     crc32 into the hashing-tokenizer id space (PAD=0, MASK=1, CLS=2,
 *     ids >= 3). Token stream matches models/tokenizer.py exactly:
 *     template tokens, variable tokens, then "key=value" pairs of the
 *     header map sorted by key.
 *   dm_count_frame_msgs / dm_featurize_frames - the same over packed wire
 *     frames (engine/framing.py), frame expansion included.
 *   dm_encode_batch - raw text lines -> token-id rows (same tokenizer).
 */
#include <pthread.h>
#include <stdatomic.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#define RESERVED 3
#define CLS_ID 2

/* Feature version of this library build. The Python bindings
 * (utils/matchkern.py DM_FEATURE_VERSION) expect exactly this number and
 * refuse a library that reports a different one; it equals the version of
 * the JAX package's dmkern.c whose featurize part this file copies. */
#ifndef DM_FEATURE_VERSION
#define DM_FEATURE_VERSION 7
#endif

int dm_feature_version(void) { return DM_FEATURE_VERSION; }

/* ---------------- tokenizer ---------------- */

static inline int is_alnum(unsigned char c) {
    return (c >= '0' && c <= '9') || (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
}

/* CRC-32 (IEEE reflected, zlib-compatible), table-driven and inlined.
 * The first version called zlib's crc32() once PER BYTE; the per-call
 * overhead (setup + length dispatch for len=1) dominated featurization —
 * measured 566 -> ~330 ns/line on the fused frame path after inlining.
 * Parity with zlib.crc32 (and so with the Python tokenizer) is bit-exact:
 * same polynomial 0xEDB88320, same pre/post inversion, pinned by
 * tests/test_torch_matchkern.py against the Python rows. */
static uint32_t dm_crc_table[256];

__attribute__((constructor)) static void dm_crc_init(void) {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        dm_crc_table[i] = c;
    }
}

/* Tokenize one byte span into out[]; returns new fill position. Lowercases
 * ASCII and feeds the crc incrementally, so tokens of any length hash
 * identically to the Python path (zlib.crc32 of the whole lowercased token).
 * `inv` carries the PRE-INVERTED crc state across bytes (h == ~inv); the
 * pre/post inversions of consecutive one-byte zlib calls cancel, so one
 * final inversion per token is exact. */
static int tokenize_span(const uint8_t *s, int len, int32_t *out, int pos,
                         int seq_len, uint32_t vocab) {
    uint32_t inv = 0xFFFFFFFFu;
    int in_token = 0;
    for (int i = 0; i <= len; i++) {
        unsigned char c = (i < len) ? s[i] : 0;
        if (i < len && is_alnum(c)) {
            if (c >= 'A' && c <= 'Z') c += 32;
            inv = dm_crc_table[(inv ^ c) & 0xFF] ^ (inv >> 8);
            in_token = 1;
        } else if (in_token) {
            uint32_t h = inv ^ 0xFFFFFFFFu;
            if (pos < seq_len) out[pos++] = RESERVED + (int32_t)(h % (vocab - RESERVED));
            inv = 0xFFFFFFFFu;
            in_token = 0;
            if (pos >= seq_len) return pos;
        }
    }
    return pos;
}

/* ---------------- protobuf wire parsing ---------------- */

typedef struct { const uint8_t *p, *end; } cursor_t;

static int read_varint(cursor_t *c, uint64_t *out) {
    uint64_t v = 0; int shift = 0;
    while (c->p < c->end && shift < 64) {
        uint8_t b = *c->p++;
        v |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) { *out = v; return 1; }
        shift += 7;
    }
    return 0;
}

static int skip_field(cursor_t *c, uint32_t wire_type) {
    uint64_t tmp;
    switch (wire_type) {
        case 0: return read_varint(c, &tmp);
        case 1: if (c->end - c->p < 8) return 0; c->p += 8; return 1;
        case 2:
            if (!read_varint(c, &tmp) || (uint64_t)(c->end - c->p) < tmp) return 0;
            c->p += tmp; return 1;
        case 5: if (c->end - c->p < 4) return 0; c->p += 4; return 1;
        default: return 0;
    }
}

typedef struct { const uint8_t *key; int key_len; const uint8_t *val; int val_len; } map_entry_t;

static int parse_map_entry(const uint8_t *p, int len, map_entry_t *e) {
    cursor_t c = { p, p + len };
    e->key = NULL; e->key_len = 0; e->val = NULL; e->val_len = 0;
    while (c.p < c.end) {
        uint64_t tag;
        if (!read_varint(&c, &tag)) return 0;
        uint32_t field = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
        if (wt == 2 && (field == 1 || field == 2)) {
            uint64_t l;
            if (!read_varint(&c, &l) || (uint64_t)(c.end - c.p) < l) return 0;
            if (field == 1) { e->key = c.p; e->key_len = (int)l; }
            else            { e->val = c.p; e->val_len = (int)l; }
            c.p += l;
        } else if (!skip_field(&c, wt)) {
            return 0;
        }
    }
    return 1;
}

static int cmp_map_entry(const void *a, const void *b) {
    const map_entry_t *x = (const map_entry_t *)a, *y = (const map_entry_t *)b;
    int n = x->key_len < y->key_len ? x->key_len : y->key_len;
    int r = memcmp(x->key, y->key, (size_t)n);
    return r ? r : x->key_len - y->key_len;
}

#define MAX_MAP_ENTRIES 64

static int utf8_valid(const uint8_t *s, int len);

/* Python's str.lower() can mint ASCII-alphanumeric characters out of
 * exactly two non-ASCII codepoints: U+0130 LATIN CAPITAL LETTER I WITH DOT
 * ABOVE ('İ'.lower() contains 'i') and U+212A KELVIN SIGN ('K'.lower() is
 * 'k') — verified by exhaustive scan over the BMP+astral planes. The C
 * tokenizer lowercases ASCII only, so a span carrying either codepoint
 * would tokenize differently from the Python path; those rows are flagged
 * for the Python fallback instead (exact parity beats a silently different
 * token stream). */
static int has_ascii_lowering_codepoint(const uint8_t *s, int len) {
    for (int i = 0; i + 1 < len; i++) {
        if (s[i] == 0xC4 && s[i + 1] == 0xB0) return 1;              /* U+0130 */
        if (i + 2 < len && s[i] == 0xE2 && s[i + 1] == 0x84 &&
            s[i + 2] == 0xAA) return 1;                              /* U+212A */
    }
    return 0;
}

/* A featurizable string span: valid UTF-8 (upb raises on invalid bytes in
 * declared string fields, so the Python path would reject the whole
 * message) and free of the two ASCII-lowering codepoints above. */
static int feat_span_ok(const uint8_t *s, int len) {
    return utf8_valid(s, len) && !has_ascii_lowering_codepoint(s, len);
}

/* Featurize one serialized ParserSchema into a zeroed row. Returns 1 on
 * success, 0 on a wire-format error or a row whose token stream cannot be
 * guaranteed byte-identical to the Python path (row left as-is). */
static int featurize_one(const uint8_t *msg, int len, int32_t *row,
                         int seq_len, uint32_t vocab) {
    cursor_t c = { msg, msg + len };
    int pos = 0;
    row[pos++] = CLS_ID;
    map_entry_t entries[MAX_MAP_ENTRIES];
    int n_entries = 0;
    const uint8_t *template_p = NULL; uint64_t template_len = 0;
    /* first pass: locate template (5), collect map entries (10), and
     * validate EVERY declared string field — upb raises on invalid UTF-8
     * anywhere in the message, so a row the Python path would reject must
     * never come back ok=1 with a guessed token stream. Tokenized spans
     * (template/variables/map) additionally reject the two ASCII-lowering
     * codepoints (feat_span_ok). */
    while (c.p < c.end) {
        uint64_t tag;
        if (!read_varint(&c, &tag)) return 0;
        uint32_t field = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
        if (wt == 2) {
            uint64_t l;
            if (!read_varint(&c, &l) || (uint64_t)(c.end - c.p) < l) return 0;
            if (field == 5) {
                if (!feat_span_ok(c.p, (int)l)) return 0;
                template_p = c.p; template_len = l;
            } else if (field == 6) {
                if (!feat_span_ok(c.p, (int)l)) return 0;
            } else if (field == 10) {
                /* more map entries than we can sort: report failure so the
                 * caller re-featurizes this row in Python (exact parity
                 * beats a silently different token stream) */
                if (n_entries >= MAX_MAP_ENTRIES) return 0;
                if (parse_map_entry(c.p, (int)l, &entries[n_entries])) {
                    map_entry_t *e = &entries[n_entries];
                    /* a wire entry omitting key or value means the empty
                     * string (proto3 map semantics), not a skipped entry */
                    if (e->key == NULL) e->key = (const uint8_t *)"";
                    if (e->val == NULL) e->val = (const uint8_t *)"";
                    if (!feat_span_ok(e->key, e->key_len) ||
                        !feat_span_ok(e->val, e->val_len))
                        return 0;
                    n_entries++;
                }
            } else if (field >= 1 && field <= 9) {
                /* declared strings (1,2,3,7,8,9): parse-time UTF-8 check */
                if (!utf8_valid(c.p, (int)l)) return 0;
            }
            c.p += l;
        } else if (!skip_field(&c, wt)) {
            return 0;
        }
    }
    if (template_p && pos < seq_len)
        pos = tokenize_span(template_p, (int)template_len, row, pos, seq_len, vocab);
    /* second pass: variables (6) in wire order, already validated above */
    c.p = msg; c.end = msg + len;
    while (c.p < c.end && pos < seq_len) {
        uint64_t tag;
        if (!read_varint(&c, &tag)) return 0;
        uint32_t field = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
        if (wt == 2) {
            uint64_t l;
            if (!read_varint(&c, &l) || (uint64_t)(c.end - c.p) < l) return 0;
            if (field == 6)
                pos = tokenize_span(c.p, (int)l, row, pos, seq_len, vocab);
            c.p += l;
        } else if (!skip_field(&c, wt)) {
            return 0;
        }
    }
    if (n_entries > 1) {
        /* proto3 maps are last-wins on duplicate wire keys: Python's dict
         * keeps one entry per key, so earlier occurrences must not emit */
        int w = 0;
        for (int i = 0; i < n_entries; i++) {
            int last = 1;
            for (int j = i + 1; j < n_entries && last; j++)
                if (entries[j].key_len == entries[i].key_len &&
                    memcmp(entries[j].key, entries[i].key,
                           (size_t)entries[i].key_len) == 0)
                    last = 0;
            if (last) entries[w++] = entries[i];
        }
        n_entries = w;
    }
    if (n_entries > 0 && pos < seq_len) {
        if (n_entries > 1)  /* the common case is a single header entry */
            qsort(entries, (size_t)n_entries, sizeof(map_entry_t), cmp_map_entry);
        for (int i = 0; i < n_entries && pos < seq_len; i++) {
            pos = tokenize_span(entries[i].key, entries[i].key_len, row, pos, seq_len, vocab);
            if (pos < seq_len)
                pos = tokenize_span(entries[i].val, entries[i].val_len, row, pos, seq_len, vocab);
        }
    }
    return 1;
}

/* ---------------- row-parallel featurization pool ----------------
 *
 * Rows are independent (each featurize_one writes only its own token row,
 * ok byte, and reads only its own payload span), so a batch shards over a
 * small persistent pthread pool. The ctypes layer calls through CDLL, which
 * drops the GIL for the duration of the C call — featurization of one
 * engine micro-batch runs on all pool threads while the Python engine
 * thread is free to drain/dispatch.
 *
 * Pool discipline: ONE job at a time (run_mu). A second concurrent caller
 * — two detectors featurizing at once — trylocks, loses, and simply runs
 * its batch inline on its own calling thread: no queueing, no deadlock,
 * and the two calls still overlap because neither holds the GIL. Work is
 * handed out in fixed row chunks via an atomic cursor (rows cost ~0.3 µs,
 * so per-row stealing would be all contention). */

#define DM_POOL_MAX 16
#define DM_FEAT_CHUNK 64

static pthread_mutex_t dm_run_mu = PTHREAD_MUTEX_INITIALIZER;
static pthread_mutex_t dm_pool_mu = PTHREAD_MUTEX_INITIALIZER;
static pthread_cond_t dm_pool_cv = PTHREAD_COND_INITIALIZER;
static pthread_cond_t dm_pool_done_cv = PTHREAD_COND_INITIALIZER;
static int dm_pool_started = 0;      /* live worker threads */
static int dm_pool_threads = -1;     /* configured width; -1 = auto */

typedef void (*dm_row_fn)(void *arg, int64_t lo, int64_t hi);
static struct {
    dm_row_fn fn;
    void *arg;
    int64_t n;
    _Atomic int64_t next;
    uint64_t gen;                    /* bumped per job, guarded by pool_mu */
    int active;                      /* workers still to check in for this job */
    int width;                       /* pool width the job was posted with */
} dm_job;

static void dm_job_drain(void) {
    for (;;) {
        int64_t lo = atomic_fetch_add(&dm_job.next, DM_FEAT_CHUNK);
        if (lo >= dm_job.n) return;
        int64_t hi = lo + DM_FEAT_CHUNK;
        if (hi > dm_job.n) hi = dm_job.n;
        dm_job.fn(dm_job.arg, lo, hi);
    }
}

/* EVERY started worker wakes on every job and checks in exactly once (the
 * job's active count is sized to the whole pool), but only workers whose
 * id fits the job's width actually drain rows — a later, NARROWER
 * set_threads must not let surplus workers check a job in while counted
 * ones are still writing rows (a caller returning early would hand Python
 * a half-filled matrix). */
static void *dm_pool_worker(void *idp) {
    int id = (int)(intptr_t)idp;
    uint64_t seen = 0;
    pthread_mutex_lock(&dm_pool_mu);
    for (;;) {
        while (dm_job.gen == seen)
            pthread_cond_wait(&dm_pool_cv, &dm_pool_mu);
        seen = dm_job.gen;
        int participate = id < dm_job.width - 1;
        pthread_mutex_unlock(&dm_pool_mu);
        if (participate)
            dm_job_drain();
        pthread_mutex_lock(&dm_pool_mu);
        if (--dm_job.active == 0)
            pthread_cond_signal(&dm_pool_done_cv);
    }
    return NULL;
}

/* Set the pool width (0/negative = auto: min(4, online cores); capped at
 * DM_POOL_MAX). Returns the effective width. Threads are created lazily on
 * the first parallel run and never torn down (they sleep on the condvar). */
int dm_featurize_set_threads(int n) {
    pthread_mutex_lock(&dm_pool_mu);
    if (n <= 0) {
        long cores = sysconf(_SC_NPROCESSORS_ONLN);
        n = cores < 1 ? 1 : (cores > 4 ? 4 : (int)cores);
    }
    if (n > DM_POOL_MAX) n = DM_POOL_MAX;
    dm_pool_threads = n;
    pthread_mutex_unlock(&dm_pool_mu);
    return n;
}

int dm_featurize_get_threads(void) {
    if (dm_pool_threads < 0) dm_featurize_set_threads(0);
    return dm_pool_threads;
}

/* Run fn over [0, n) rows, sharded across the pool (calling thread
 * included). Falls back to inline execution for small batches, a width-1
 * pool, or when another call already owns the pool. */
static void dm_run_rows(dm_row_fn fn, void *arg, int64_t n) {
    int width = dm_featurize_get_threads();
    if (width <= 1 || n < 2 * DM_FEAT_CHUNK ||
        pthread_mutex_trylock(&dm_run_mu) != 0) {
        fn(arg, 0, n);
        return;
    }
    pthread_mutex_lock(&dm_pool_mu);
    while (dm_pool_started < width - 1) {   /* caller is the width'th worker */
        pthread_t t;
        pthread_attr_t attr;
        pthread_attr_init(&attr);
        pthread_attr_setdetachstate(&attr, PTHREAD_CREATE_DETACHED);
        if (pthread_create(&t, &attr, dm_pool_worker,
                           (void *)(intptr_t)dm_pool_started) != 0) {
            pthread_attr_destroy(&attr);
            break;                          /* degraded pool still works */
        }
        pthread_attr_destroy(&attr);
        dm_pool_started++;
    }
    dm_job.fn = fn;
    dm_job.arg = arg;
    dm_job.n = n;
    atomic_store(&dm_job.next, 0);
    dm_job.active = dm_pool_started;        /* every worker checks in */
    dm_job.width = width;
    dm_job.gen++;
    pthread_cond_broadcast(&dm_pool_cv);
    pthread_mutex_unlock(&dm_pool_mu);
    dm_job_drain();                         /* caller works its share */
    pthread_mutex_lock(&dm_pool_mu);
    while (dm_job.active > 0)
        pthread_cond_wait(&dm_pool_done_cv, &dm_pool_mu);
    pthread_mutex_unlock(&dm_pool_mu);
    pthread_mutex_unlock(&dm_run_mu);
}

/* Shared row task: featurize spans[2i, 2i+1) of blob into row i. */
typedef struct {
    const uint8_t *blob;
    const int64_t *spans;       /* [2n] start/end pairs */
    int64_t span_stride;        /* 2 for span pairs, 1 for prefix offsets */
    int32_t *out;
    uint8_t *ok;
    int seq_len;
    uint32_t vocab;
} feat_rows_t;

static void feat_rows_run(void *argp, int64_t lo, int64_t hi) {
    feat_rows_t *a = (feat_rows_t *)argp;
    for (int64_t i = lo; i < hi; i++) {
        int64_t s = a->spans[a->span_stride * i];
        int64_t e = a->spans[a->span_stride == 2 ? 2 * i + 1 : i + 1];
        a->ok[i] = (uint8_t)featurize_one(a->blob + s, (int)(e - s),
                                          a->out + i * a->seq_len,
                                          a->seq_len, a->vocab);
    }
}

/* msgs: concatenated message bytes; offsets: n+1 prefix offsets into msgs.
 * out: zeroed [n, seq_len] int32. ok: [n] bytes, 1 = parsed. Rows shard
 * over the featurize pool (see above). */
int dm_featurize_batch(const uint8_t *msgs, const int64_t *offsets, int n,
                       int32_t *out, uint8_t *ok, int seq_len, int32_t vocab) {
    feat_rows_t task = { msgs, offsets, 1, out, ok, seq_len, (uint32_t)vocab };
    dm_run_rows(feat_rows_run, &task, n);
    return 0;
}

/* ---------------- fused wire-frame featurization ----------------
 *
 * The service's packed wire format (engine/framing.py):
 *   0xD7 'D' 'M' 0x01 | varint n | n x (varint len | len bytes)
 * A frame without the magic is a single message. Fusing frame expansion
 * with featurization removes the per-message Python objects (bytes slices,
 * list appends, per-message loop) that set the ~6 us/msg service-path
 * floor: the engine hands whole frames down, and per-message work happens
 * entirely in C until alert construction (~1% of messages).
 */

static int frame_is_batch(const uint8_t *p, int len) {
    return len >= 4 && p[0] == 0xD7 && p[1] == 'D' && p[2] == 'M' && p[3] == 0x01;
}

/* Newline line-count rule shared with the Python engine (_count_lines):
 * newline count, plus one for a final unterminated line, minimum 1. */
static int64_t count_lines_rule(const uint8_t *p, uint64_t len) {
    int64_t nl = 0;
    const uint8_t *q = p, *end = p + len;
    while ((q = memchr(q, '\n', (size_t)(end - q))) != NULL) { nl++; q++; }
    if (len == 0 || p[len - 1] != '\n') nl++;
    return nl < 1 ? 1 : nl;
}

/* Count + validate the messages in each frame. counts[i] = NON-EMPTY
 * messages in frame i (packed zero-length messages are filtered, matching
 * the engine's expansion semantics — counting them would let a sender buy
 * huge row allocations for one wire byte each); corrupt[i] = 1 when a
 * batch frame's body is malformed (its count is then 0 — the caller falls
 * back / counts the error). *lines_out (nullable) accumulates the engine's
 * newline line-count rule over the counted messages so read metrics stay
 * in one unit with the written/dropped side. Returns the total message
 * count across valid frames. */
int64_t dm_count_frame_msgs(const uint8_t *frames, const int64_t *frame_offsets,
                            int n_frames, int32_t *counts, uint8_t *corrupt,
                            int64_t *lines_out) {
    int64_t total = 0, lines = 0;
    for (int i = 0; i < n_frames; i++) {
        const uint8_t *p = frames + frame_offsets[i];
        int len = (int)(frame_offsets[i + 1] - frame_offsets[i]);
        counts[i] = 0;
        corrupt[i] = 0;
        if (!frame_is_batch(p, len)) {
            if (len > 0) {
                counts[i] = 1;
                total += 1;
                lines += count_lines_rule(p, (uint64_t)len);
            }
            continue;
        }
        cursor_t c = { p + 4, p + len };
        uint64_t n_msgs;
        if (!read_varint(&c, &n_msgs) || n_msgs > (uint64_t)INT32_MAX) {
            corrupt[i] = 1;
            continue;
        }
        uint64_t seen = 0;
        int64_t frame_count = 0, frame_lines = 0;
        for (; seen < n_msgs; seen++) {
            uint64_t mlen;
            if (!read_varint(&c, &mlen) || (uint64_t)(c.end - c.p) < mlen) break;
            if (mlen > 0) {
                frame_count++;
                frame_lines += count_lines_rule(c.p, mlen);
            }
            c.p += mlen;
        }
        if (seen != n_msgs || c.p != c.end) {  /* truncated or trailing bytes */
            corrupt[i] = 1;
            continue;
        }
        counts[i] = (int32_t)frame_count;
        total += frame_count;
        lines += frame_lines;
    }
    if (lines_out) *lines_out = lines;
    return total;
}

/* Featurize every message of every (pre-validated) frame. Outputs, in frame
 * order then message order: token rows, ok flags, and [start, end) byte
 * spans into the frames blob so Python can lazily slice the raw bytes of
 * just the anomalous messages. Caller sizes the outputs from
 * dm_count_frame_msgs and zeroes `tokens`. Returns messages written.
 *
 * Two phases: a cheap sequential varint walk enumerates the message spans
 * (frame expansion is inherently serial — each length prefixes the next),
 * then the independent rows featurize in parallel over the pool straight
 * from the span table. */
int64_t dm_featurize_frames(const uint8_t *frames, const int64_t *frame_offsets,
                            int n_frames, const int32_t *counts,
                            const uint8_t *corrupt,
                            int32_t *tokens, uint8_t *ok, int64_t *spans,
                            int seq_len, int32_t vocab) {
    int64_t m = 0;
    for (int i = 0; i < n_frames; i++) {
        const uint8_t *base = frames + frame_offsets[i];
        int len = (int)(frame_offsets[i + 1] - frame_offsets[i]);
        if (corrupt[i] || counts[i] == 0) continue;
        if (!frame_is_batch(base, len)) {
            spans[2 * m] = frame_offsets[i];
            spans[2 * m + 1] = frame_offsets[i + 1];
            m++;
            continue;
        }
        cursor_t c = { base + 4, base + len };
        uint64_t n_msgs;
        read_varint(&c, &n_msgs);          /* pre-validated by the count pass */
        for (uint64_t k = 0; k < n_msgs; k++) {
            uint64_t mlen;
            read_varint(&c, &mlen);
            if (mlen > 0) {                /* packed empties: filtered, no row */
                spans[2 * m] = frame_offsets[i] + (c.p - base);
                spans[2 * m + 1] = spans[2 * m] + (int64_t)mlen;
                m++;
            }
            c.p += mlen;
        }
    }
    feat_rows_t task = { frames, spans, 2, tokens, ok, seq_len, (uint32_t)vocab };
    dm_run_rows(feat_rows_run, &task, m);
    return m;
}

/* Raw text lines -> token rows (same tokenizer). */
int dm_encode_batch(const uint8_t *texts, const int64_t *offsets, int n,
                    int32_t *out, int seq_len, int32_t vocab) {
    for (int i = 0; i < n; i++) {
        int32_t *row = out + (int64_t)i * seq_len;
        row[0] = CLS_ID;
        tokenize_span(texts + offsets[i], (int)(offsets[i + 1] - offsets[i]),
                      row, 1, seq_len, (uint32_t)vocab);
    }
    return 0;
}


/* ---------------- UTF-8 validation ---------------- */

static int utf8_valid(const uint8_t *s, int len) {
    int i = 0;
    while (i < len) {
        uint8_t c = s[i];
        if (c < 0x80) { i++; continue; }
        int n;
        uint32_t cp;
        if ((c & 0xE0) == 0xC0) { n = 1; cp = c & 0x1F; }
        else if ((c & 0xF0) == 0xE0) { n = 2; cp = c & 0x0F; }
        else if ((c & 0xF8) == 0xF0) { n = 3; cp = c & 0x07; }
        else return 0;
        if (i + n >= len) return 0;             /* truncated sequence */
        for (int k = 1; k <= n; k++) {
            if ((s[i + k] & 0xC0) != 0x80) return 0;
            cp = (cp << 6) | (s[i + k] & 0x3F);
        }
        if (n == 1 && cp < 0x80) return 0;
        if (n == 2 && (cp < 0x800 || (cp >= 0xD800 && cp <= 0xDFFF))) return 0;
        if (n == 3 && (cp < 0x10000 || cp > 0x10FFFF)) return 0;
        i += n + 1;
    }
    return 1;
}
