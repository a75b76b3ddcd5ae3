/* dmfeat: the native host kernels of the PyTorch port.
 *
 * The port's own copy of native/matchkern/dmkern.c's featurize part (its
 * lines 1-584 and its utf8_valid), its template matcher and fused parser
 * (lines 585-1285) and its LogSchema decode and ParserSchema emit (lines
 * 1469-1686), with the same semantics; the NewValueDetector scan and the
 * shm refcounts of that file are not here. Exposed to Python through
 * ctypes (detectmateservice_tpu_torch/utils/matchkern.py), which builds
 * this file with the host C compiler at its first call.
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
 *   dm_match_templates / dm_match_extract / dm_match_extract_batch -
 *     normalized lines vs <*> wildcard templates (first match wins) ->
 *     template index and the wildcard captures' byte spans.
 *   dm_parse_batch / dm_parse_frames - the MatcherParser row in one pass:
 *     LogSchema payload -> header extraction -> normalize -> template
 *     match -> serialized ParserSchema; rows it cannot do exactly go back
 *     to Python.
 *   dm_parse_logs_batch / dm_parse_logs_frames - LogSchema decode only:
 *     (log, logID) byte spans per payload.
 *   dm_emit_parser_rows - ParserSchema rows serialized from fields Python
 *     computed.
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

/* ---------------- template matching ---------------- */

/* Templates are passed pre-normalized and pre-split: seg_data holds all
 * literal segments concatenated; seg_offsets/seg_counts describe, per
 * template, its literal segments (split on "<*>"). Matching: anchored first
 * segment (unless template starts with <*>), anchored last segment (unless
 * it ends with <*>), in-order containment for the middle ones — the
 * wildcard-matching semantics of the Python fallback regex
 * (library/parsers/template_matcher.py compile_template). Returns the
 * 0-based index of the first matching template, or -1. */
int dm_match_templates(const uint8_t *line, int line_len,
                       const uint8_t *seg_data, const int64_t *seg_offsets,
                       const int32_t *seg_counts, const uint8_t *starts_wild,
                       const uint8_t *ends_wild, int n_templates) {
    int64_t seg_idx = 0;
    for (int t = 0; t < n_templates; t++) {
        int n_segs = seg_counts[t];
        const uint8_t *pos = line;
        const uint8_t *end = line + line_len;
        int okflag = 1;
        if (n_segs == 1 && !starts_wild[t] && !ends_wild[t]) {
            /* wildcard-free template: whole-line equality, not prefix —
             * 'connection closed' must not claim 'connection closed by x' */
            int seg_len = (int)(seg_offsets[seg_idx + 1] - seg_offsets[seg_idx]);
            if (line_len == seg_len &&
                memcmp(line, seg_data + seg_offsets[seg_idx], (size_t)seg_len) == 0)
                return t;
            seg_idx += 1;
            continue;
        }
        for (int s = 0; s < n_segs && okflag; s++) {
            const uint8_t *seg = seg_data + seg_offsets[seg_idx + s];
            int seg_len = (int)(seg_offsets[seg_idx + s + 1] - seg_offsets[seg_idx + s]);
            if (seg_len == 0) continue;
            if (s == 0 && !starts_wild[t]) {
                if (end - pos < seg_len || memcmp(pos, seg, (size_t)seg_len) != 0)
                    okflag = 0;
                else
                    pos += seg_len;
            } else if (s == n_segs - 1 && !ends_wild[t]) {
                if (pos > end - seg_len ||
                    memcmp(end - seg_len, seg, (size_t)seg_len) != 0)
                    okflag = 0;
                else
                    pos = end;
            } else {
                /* in-order containment (memmem) */
                const uint8_t *found = NULL;
                for (const uint8_t *q = pos; q + seg_len <= end; q++) {
                    if (memcmp(q, seg, (size_t)seg_len) == 0) { found = q; break; }
                }
                if (!found) okflag = 0; else pos = found + seg_len;
            }
        }
        if (okflag) return t;
        seg_idx += n_segs; /* offsets are one global prefix array */
    }
    return -1;
}

/* Match + extract: like dm_match_templates, but for the winning template
 * fills caps[2k]=start, caps[2k+1]=end (byte offsets into `line`) for each
 * wildcard gap between consecutive segments. Capture semantics mirror the
 * extraction regex "^s0(.*?)s1(.*?)...(.*)slast$": middle segments match at
 * their leftmost position after the previous match, an anchored last
 * segment matches at the line end, and empty boundary segments (from a
 * template starting/ending with <*>) capture from the line start / to the
 * line end. Returns the template index, -1 for no match, or -2 when the
 * winner has more captures than max_caps (caller falls back to the regex).
 */
static int match_extract_one(const uint8_t *line, int line_len,
                             const uint8_t *seg_data, const int64_t *seg_offsets,
                             const int32_t *seg_counts, const uint8_t *starts_wild,
                             const uint8_t *ends_wild, int n_templates,
                             int32_t *caps, int max_caps, int32_t *n_caps_out) {
    int64_t seg_idx = 0;
    for (int t = 0; t < n_templates; t++) {
        int n_segs = seg_counts[t];
        const uint8_t *pos = line;
        const uint8_t *end = line + line_len;
        const uint8_t *prev_end = line;
        int okflag = 1;
        int nc = 0;
        int overflow = 0;
        if (n_segs == 1 && !starts_wild[t] && !ends_wild[t]) {
            /* wildcard-free template: whole-line equality (see
             * dm_match_templates) — zero captures on match */
            int seg_len = (int)(seg_offsets[seg_idx + 1] - seg_offsets[seg_idx]);
            if (line_len == seg_len &&
                memcmp(line, seg_data + seg_offsets[seg_idx], (size_t)seg_len) == 0) {
                *n_caps_out = 0;
                return t;
            }
            seg_idx += 1;
            continue;
        }
        for (int s = 0; s < n_segs && okflag; s++) {
            const uint8_t *seg = seg_data + seg_offsets[seg_idx + s];
            int seg_len = (int)(seg_offsets[seg_idx + s + 1] - seg_offsets[seg_idx + s]);
            const uint8_t *mstart;
            if (seg_len == 0) {
                /* empty boundary segment: zero-length match at pos, or at
                 * the line end when it is the trailing segment */
                mstart = (s == n_segs - 1) ? end : pos;
            } else if (s == 0 && !starts_wild[t]) {
                if (end - pos < seg_len || memcmp(pos, seg, (size_t)seg_len) != 0) {
                    okflag = 0;
                    break;
                }
                mstart = pos;
            } else if (s == n_segs - 1 && !ends_wild[t]) {
                if (pos > end - seg_len ||
                    memcmp(end - seg_len, seg, (size_t)seg_len) != 0) {
                    okflag = 0;
                    break;
                }
                mstart = end - seg_len;
            } else {
                const uint8_t *found = NULL;
                for (const uint8_t *q = pos; q + seg_len <= end; q++) {
                    if (memcmp(q, seg, (size_t)seg_len) == 0) { found = q; break; }
                }
                if (!found) { okflag = 0; break; }
                mstart = found;
            }
            if (s > 0) {
                if (nc < max_caps) {
                    caps[2 * nc] = (int32_t)(prev_end - line);
                    caps[2 * nc + 1] = (int32_t)(mstart - line);
                } else {
                    overflow = 1;
                }
                nc++;
            }
            prev_end = mstart + seg_len;
            pos = prev_end;
        }
        if (okflag) {
            if (overflow) return -2;
            *n_caps_out = nc;
            return t;
        }
        seg_idx += n_segs;
    }
    *n_caps_out = 0;
    return -1;
}

int dm_match_extract(const uint8_t *line, int line_len,
                     const uint8_t *seg_data, const int64_t *seg_offsets,
                     const int32_t *seg_counts, const uint8_t *starts_wild,
                     const uint8_t *ends_wild, int n_templates,
                     int32_t *caps, int max_caps, int32_t *n_caps_out) {
    return match_extract_one(line, line_len, seg_data, seg_offsets, seg_counts,
                             starts_wild, ends_wild, n_templates,
                             caps, max_caps, n_caps_out);
}

/* Batch variant: one ctypes crossing for a whole engine micro-batch (the
 * per-call ctypes overhead was ~20 us/line — larger than the scan itself).
 * lines = concatenated line bytes, line_offsets = n_lines+1 prefix offsets;
 * outputs: idx_out[i] (template index / -1 / -2), ncaps_out[i], and
 * caps_out[i * 2*max_caps ...] byte spans RELATIVE to each line's start. */
void dm_match_extract_batch(const uint8_t *lines, const int64_t *line_offsets,
                            int n_lines,
                            const uint8_t *seg_data, const int64_t *seg_offsets,
                            const int32_t *seg_counts, const uint8_t *starts_wild,
                            const uint8_t *ends_wild, int n_templates,
                            int32_t *idx_out, int32_t *caps_out,
                            int32_t *ncaps_out, int max_caps) {
    for (int i = 0; i < n_lines; i++) {
        const uint8_t *line = lines + line_offsets[i];
        int line_len = (int)(line_offsets[i + 1] - line_offsets[i]);
        idx_out[i] = match_extract_one(
            line, line_len, seg_data, seg_offsets, seg_counts, starts_wild,
            ends_wild, n_templates,
            caps_out + (size_t)i * 2 * max_caps, max_caps, ncaps_out + i);
    }
}

/* ---------------- fused parser path (dm_parse_batch) ----------------
 *
 * One C pass for the MatcherParser batch hot path: LogSchema payload ->
 * (logID, log) -> log_format header extraction -> content normalization ->
 * template match + wildcard captures -> serialized ParserSchema bytes.
 * Profiled before this kernel existed, the Python batch path spent its
 * ~12 us/line roughly 31% building pb2 outputs, 23% in the header regex,
 * 14% marshalling for the match kernel, and the rest in decode/serialize —
 * all of it fused here.
 *
 * Exactness contract: every row this kernel EMITS is field-identical to
 * what the Python path produces (pinned by tests/test_torch_pipeline_stages.py);
 * any row it cannot guarantee that for gets status -1 and the caller
 * re-runs it through the Python path:
 *   - payloads that are not LogSchema protobufs in accept_raw mode
 *     (JSON records, invalid UTF-8 — Python applies its own fallbacks),
 *   - strict-mode parse failures (Python raises/counts the exact error),
 *   - lowercase normalization on non-ASCII content (str.lower() is
 *     Unicode-aware, C is not),
 *   - lines whose ASCII bytes are all whitespace but that carry high
 *     bytes (str.strip() knows Unicode whitespace),
 *   - capture-buffer overflow in the template matcher.
 * Header extraction needs no backtracking fallback: with anchored-prefix /
 * leftmost-middle / anchored-suffix literal placement, a failure is
 * definitive and a success is exactly what the non-greedy regex commits to
 * (later literal occurrences only shrink the room for the rest).
 *
 * Status codes: 1 emitted, 0 filtered (blank line -> None), -1 Python.
 */


/* 0 = non-blank, 1 = blank (all ASCII whitespace), -1 = ambiguous (only
 * whitespace ASCII but high bytes present: Python's Unicode strip() may
 * still blank it). Python str.strip() whitespace includes \x1c-\x1f. */
static int blank_class(const uint8_t *s, int len) {
    int high = 0;
    for (int i = 0; i < len; i++) {
        uint8_t c = s[i];
        if (c >= 0x80) { high = 1; continue; }
        if (!(c == ' ' || (c >= 0x09 && c <= 0x0D) || (c >= 0x1C && c <= 0x1F)))
            return 0;
    }
    return high ? -1 : 1;
}

static const uint8_t *find_lit(const uint8_t *hay, const uint8_t *end,
                               const uint8_t *lit, int lit_len) {
    for (const uint8_t *q = hay; q + lit_len <= end; q++)
        if (memcmp(q, lit, (size_t)lit_len) == 0) return q;
    return NULL;
}

static int is_ascii_punct(uint8_t c) {  /* string.punctuation */
    return (c >= '!' && c <= '/') || (c >= ':' && c <= '@') ||
           (c >= '[' && c <= '`') || (c >= '{' && c <= '~');
}

/* Apply remove_spaces / remove_punctuation piecewise OUTSIDE "<*>"
 * occurrences (the Python _normalize splits on the wildcard and rejoins);
 * lowercase applies to the whole string (ASCII-only — caller guarantees
 * no high bytes when the flag is set). Order matches Python: lowercase,
 * then punctuation, then spaces. Writes to dst, returns new length
 * (never longer than len). */
#define NORM_SPACES 1
#define NORM_PUNCT 2
#define NORM_LOWER 4

static int normalize_span(const uint8_t *s, int len, uint8_t *dst, int flags) {
    int o = 0;
    int i = 0;
    while (i < len) {
        if (len - i >= 3 && s[i] == '<' && s[i + 1] == '*' && s[i + 2] == '>') {
            dst[o++] = '<'; dst[o++] = '*'; dst[o++] = '>';
            i += 3;
            continue;
        }
        uint8_t c = s[i++];
        if ((flags & NORM_LOWER) && c >= 'A' && c <= 'Z') c += 32;
        if ((flags & NORM_PUNCT) && is_ascii_punct(c)) continue;
        if ((flags & NORM_SPACES) && c == ' ') continue;
        dst[o++] = c;
    }
    return o;
}

/* -- minimal protobuf emit helpers -- */
static inline int64_t emit_varint(uint8_t *out, int64_t o, uint64_t v) {
    while (v >= 0x80) { out[o++] = (uint8_t)(v | 0x80); v >>= 7; }
    out[o++] = (uint8_t)v;
    return o;
}

static inline int64_t emit_str(uint8_t *out, int64_t o, uint32_t field,
                               const uint8_t *s, int len) {
    o = emit_varint(out, o, (uint64_t)(field << 3) | 2);
    o = emit_varint(out, o, (uint64_t)len);
    memcpy(out + o, s, (size_t)len);
    return o + len;
}

static inline int64_t emit_i32(uint8_t *out, int64_t o, uint32_t field,
                               int32_t v) {
    o = emit_varint(out, o, (uint64_t)(field << 3));
    /* int32 wire format sign-extends negatives to 64 bits (10-byte varint
     * for EventID = -1), exactly like upb */
    return emit_varint(out, o, (uint64_t)(int64_t)v);
}

static int64_t varint_size(uint64_t v) {
    int64_t n = 1;
    while (v >= 0x80) { v >>= 7; n++; }
    return n;
}

/* Config + output state shared by the batch and frames drivers. */
typedef struct {
    int accept_raw;
    const uint8_t *lit_data; const int64_t *lit_offsets; int n_lits;
    const uint8_t *name_data; const int64_t *name_offsets;
    int content_cap;
    int norm_flags;
    const uint8_t *seg_data; const int64_t *seg_offsets;
    const int32_t *seg_counts; const uint8_t *starts_wild;
    const uint8_t *ends_wild; int n_templates;
    const uint8_t *tmpl_data; const int64_t *tmpl_offsets;
    int max_caps;
    const uint8_t *version; int version_len;
    const uint8_t *parser_type; int parser_type_len;
    const uint8_t *parser_id; int parser_id_len;
    int64_t now; const uint8_t *rand_hex;
    uint8_t *out_buf; int64_t out_cap;
    /* mutable per-call state */
    int64_t o;
    uint8_t *scratch; int scratch_cap;
    int32_t *tcaps;
} parse_ctx_t;

/* Parse one payload. Fills status_out (1 emitted / 0 filtered / -1 Python)
 * and advances ctx->o. Returns 0; -1 on output-capacity shortfall (caller
 * aborts the whole call and retries with a bigger buffer); -2 on malloc
 * failure (real OOM — retrying with a BIGGER buffer would only dig deeper,
 * so the binding layer raises instead of growing). */
static int parse_one_row(parse_ctx_t *ctx, const uint8_t *pay, int pay_len,
                         int64_t row_idx, int8_t *status_out) {
    int n_caps_fmt = ctx->n_lits > 0 ? ctx->n_lits - 1 : 0;
    *status_out = -1; /* default: Python handles it */

    /* 1. LogSchema decode (fields: logID=2, log=3; presence of 1-5) */
    const uint8_t *log = NULL; int log_len = 0;
    const uint8_t *log_id = NULL; int log_id_len = 0;
    int presence = 0, parse_ok = 1;
    {
        cursor_t c = { pay, pay + pay_len };
        while (c.p < c.end) {
            uint64_t tag;
            if (!read_varint(&c, &tag)) { parse_ok = 0; break; }
            uint32_t field = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
            if (field == 0) { parse_ok = 0; break; }
            if (wt == 2 && (field == 2 || field == 3)) {
                uint64_t l;
                if (!read_varint(&c, &l) || (uint64_t)(c.end - c.p) < l) { parse_ok = 0; break; }
                /* upb validates UTF-8 on every declared string at parse
                 * time: invalid bytes mean ParseFromString raises, which
                 * is parse failure — not a successfully-parsed envelope */
                if (!utf8_valid(c.p, (int)l)) { parse_ok = 0; break; }
                if (field == 2) { log_id = c.p; log_id_len = (int)l; }
                else { log = c.p; log_len = (int)l; }
                c.p += l;
                presence = 1;
            } else if (wt == 2 && field >= 1 && field <= 5) {
                /* presence mirrors HasField(): only a CORRECT wire type
                 * (all LogSchema fields 1-5 are strings, wt 2) counts --
                 * a wrong-wire-type field is an unknown field to proto3
                 * and must not make a payload look like an envelope.
                 * UTF-8 is checked on ALL of 1-5 (__version__, logSource,
                 * hostname too): upb rejects the whole message on any
                 * invalid declared string. */
                uint64_t l;
                if (!read_varint(&c, &l) || (uint64_t)(c.end - c.p) < l) { parse_ok = 0; break; }
                if (!utf8_valid(c.p, (int)l)) { parse_ok = 0; break; }
                c.p += l;
                presence = 1;
            } else {
                if (!skip_field(&c, wt)) { parse_ok = 0; break; }
            }
        }
    }
    if (parse_ok && (!ctx->accept_raw || presence)) {
        if (log == NULL) { log = pay; log_len = 0; }
        if (log_id == NULL) { log_id = pay; log_id_len = 0; }
    } else if (ctx->accept_raw) {
        /* raw-line shape: JSON records go to Python; strip ONE trailing
         * newline (the single_value formatter's add_newline) */
        if (pay_len > 0 && pay[0] == '{') return 0;
        log = pay; log_len = pay_len;
        if (log_len > 0 && log[log_len - 1] == '\n') log_len--;
        log_id = pay; log_id_len = 0;
    } else {
        return 0; /* strict parse error -> Python */
    }
    if (!utf8_valid(log, log_len) || !utf8_valid(log_id, log_id_len))
        return 0;

    /* 2. blank filter (Python: `if not log_line.strip(): return None`) */
    int bc = blank_class(log, log_len);
    if (bc == -1) return 0;
    if (bc == 1) { *status_out = 0; return 0; }

    /* Embedded newlines change the regex semantics the header extraction
     * mirrors (Python's `.` never crosses `\n`, and `$` also matches
     * BEFORE a trailing newline) -- those rows go to Python rather than
     * risking divergent captures. Rare: upstream tailers split on
     * newlines. */
    if (memchr(log, '\n', (size_t)log_len) != NULL) return 0;

    /* 3. header extraction */
    const uint8_t *caps_s[64]; int caps_l[64];
    int n_caps = 0, header_matched = 0;
    if (ctx->n_lits > 0 && n_caps_fmt <= 64) {
        const uint8_t *pos = log;
        const uint8_t *end = log + log_len;
        const uint8_t *lit0 = ctx->lit_data + ctx->lit_offsets[0];
        int lit0_len = (int)(ctx->lit_offsets[1] - ctx->lit_offsets[0]);
        int okflag = 1;
        if (lit0_len > 0) {
            if (end - pos < lit0_len || memcmp(pos, lit0, (size_t)lit0_len) != 0)
                okflag = 0;
            else
                pos += lit0_len;
        }
        for (int c = 0; okflag && c < n_caps_fmt; c++) {
            const uint8_t *lit = ctx->lit_data + ctx->lit_offsets[c + 1];
            int lit_len = (int)(ctx->lit_offsets[c + 2] - ctx->lit_offsets[c + 1]);
            if (c == n_caps_fmt - 1) {
                if (lit_len == 0) {
                    caps_s[c] = pos; caps_l[c] = (int)(end - pos);
                    pos = end;
                } else if (end - log >= lit_len &&
                           end - lit_len >= pos &&
                           memcmp(end - lit_len, lit, (size_t)lit_len) == 0) {
                    caps_s[c] = pos; caps_l[c] = (int)(end - lit_len - pos);
                    pos = end;
                } else {
                    okflag = 0;
                }
            } else if (lit_len == 0) {
                caps_s[c] = pos; caps_l[c] = 0; /* adjacent captures */
            } else {
                const uint8_t *found = find_lit(pos, end, lit, lit_len);
                if (!found) { okflag = 0; break; }
                caps_s[c] = pos; caps_l[c] = (int)(found - pos);
                pos = found + lit_len;
            }
        }
        if (okflag && n_caps_fmt == 0) {
            /* capture-free format: anchored whole-line equality */
            okflag = (lit0_len == log_len);
        }
        if (okflag) { header_matched = 1; n_caps = n_caps_fmt; }
    } else if (ctx->n_lits > 0) {
        return 0; /* >64 captures: Python */
    }

    const uint8_t *content = log; int content_len = log_len;
    if (header_matched && ctx->content_cap >= 0 && ctx->content_cap < n_caps) {
        content = caps_s[ctx->content_cap];
        content_len = caps_l[ctx->content_cap];
    }

    /* 4. normalize content for matching */
    if ((ctx->norm_flags & NORM_LOWER)) {
        int high = 0;
        for (int k = 0; k < content_len; k++)
            if (content[k] >= 0x80) { high = 1; break; }
        if (high) return 0; /* Unicode lower() */
    }
    const uint8_t *norm = content; int norm_len = content_len;
    if (ctx->norm_flags) {
        if (content_len > ctx->scratch_cap) {
            free(ctx->scratch);
            ctx->scratch_cap = content_len * 2 + 256;
            ctx->scratch = (uint8_t *)malloc((size_t)ctx->scratch_cap);
            if (!ctx->scratch) { ctx->scratch_cap = 0; return -2; }
        }
        norm_len = normalize_span(content, content_len, ctx->scratch,
                                  ctx->norm_flags);
        norm = ctx->scratch;
    }

    /* 5. template match + captures */
    int event_id = -1;
    const uint8_t *tmpl = NULL; int tmpl_len = 0;
    int32_t tn_caps = 0;
    if (ctx->n_templates > 0) {
        int idx = match_extract_one(norm, norm_len, ctx->seg_data,
                                    ctx->seg_offsets, ctx->seg_counts,
                                    ctx->starts_wild, ctx->ends_wild,
                                    ctx->n_templates, ctx->tcaps,
                                    ctx->max_caps, &tn_caps);
        if (idx == -2) return 0;
        if (idx >= 0) {
            event_id = idx + 1;
            tmpl = ctx->tmpl_data + ctx->tmpl_offsets[idx];
            tmpl_len = (int)(ctx->tmpl_offsets[idx + 1] - ctx->tmpl_offsets[idx]);
        }
    }

    /* 6. capacity check then emit */
    int64_t names_total = n_caps
        ? (ctx->name_offsets[n_caps] - ctx->name_offsets[0]) : 0;
    int64_t bound = 64 + ctx->version_len + ctx->parser_type_len
        + 2 * ctx->parser_id_len + tmpl_len + 32 + log_id_len + names_total
        + (int64_t)log_len + (int64_t)norm_len
        + 16LL * (n_caps + (int64_t)tn_caps)
        + varint_size((uint64_t)ctx->now) * 2 + 20;
    if (ctx->o + bound > ctx->out_cap) return -1;

    uint8_t *out_buf = ctx->out_buf;
    int64_t o = ctx->o;
    o = emit_str(out_buf, o, 1, ctx->version, ctx->version_len);
    o = emit_str(out_buf, o, 2, ctx->parser_type, ctx->parser_type_len);
    o = emit_str(out_buf, o, 3, ctx->parser_id, ctx->parser_id_len);
    o = emit_i32(out_buf, o, 4, event_id);
    o = emit_str(out_buf, o, 5, tmpl ? tmpl : (const uint8_t *)"", tmpl_len);
    for (int k = 0; k < tn_caps; k++)
        o = emit_str(out_buf, o, 6, norm + ctx->tcaps[2 * k],
                     ctx->tcaps[2 * k + 1] - ctx->tcaps[2 * k]);
    o = emit_str(out_buf, o, 7, ctx->rand_hex + row_idx * 32, 32);
    o = emit_str(out_buf, o, 8, log_id, log_id_len);
    o = emit_str(out_buf, o, 9, ctx->parser_id, ctx->parser_id_len);
    for (int k = 0; k < n_caps; k++) {
        const uint8_t *key = ctx->name_data + ctx->name_offsets[k];
        int key_len = (int)(ctx->name_offsets[k + 1] - ctx->name_offsets[k]);
        /* duplicate capture names collapse like dict(zip(names, caps)):
         * ONE map entry at the first occurrence's position carrying the
         * LAST occurrence's value -- emitting every capture would put
         * extra wire entries the Python path never serializes (and the
         * featurizer tokenizes raw wire entries, so downstream features
         * would diverge by parser path) */
        int first = 1;
        for (int j = 0; j < k && first; j++)
            if ((int)(ctx->name_offsets[j + 1] - ctx->name_offsets[j]) == key_len &&
                memcmp(ctx->name_data + ctx->name_offsets[j], key, (size_t)key_len) == 0)
                first = 0;
        if (!first) continue;
        int vidx = k;
        for (int j = k + 1; j < n_caps; j++)
            if ((int)(ctx->name_offsets[j + 1] - ctx->name_offsets[j]) == key_len &&
                memcmp(ctx->name_data + ctx->name_offsets[j], key, (size_t)key_len) == 0)
                vidx = j;
        int64_t sub_len = 1 + varint_size((uint64_t)key_len) + key_len
            + 1 + varint_size((uint64_t)caps_l[vidx]) + caps_l[vidx];
        o = emit_varint(out_buf, o, (10u << 3) | 2);
        o = emit_varint(out_buf, o, (uint64_t)sub_len);
        o = emit_str(out_buf, o, 1, key, key_len);
        o = emit_str(out_buf, o, 2, caps_s[vidx], caps_l[vidx]);
    }
    o = emit_i32(out_buf, o, 11, (int32_t)ctx->now);
    o = emit_i32(out_buf, o, 12, (int32_t)ctx->now);
    ctx->o = o;
    *status_out = 1;
    return 0;
}

#define PARSE_CTX_ARGS \
    int accept_raw, \
    const uint8_t *lit_data, const int64_t *lit_offsets, int n_lits, \
    const uint8_t *name_data, const int64_t *name_offsets, \
    int content_cap, int norm_flags, \
    const uint8_t *seg_data, const int64_t *seg_offsets, \
    const int32_t *seg_counts, const uint8_t *starts_wild, \
    const uint8_t *ends_wild, int n_templates, \
    const uint8_t *tmpl_data, const int64_t *tmpl_offsets, int max_caps, \
    const uint8_t *version, int version_len, \
    const uint8_t *parser_type, int parser_type_len, \
    const uint8_t *parser_id, int parser_id_len, \
    int64_t now, const uint8_t *rand_hex, \
    uint8_t *out_buf, int64_t out_cap

static int parse_ctx_init(parse_ctx_t *ctx, PARSE_CTX_ARGS) {
    ctx->accept_raw = accept_raw;
    ctx->lit_data = lit_data; ctx->lit_offsets = lit_offsets; ctx->n_lits = n_lits;
    ctx->name_data = name_data; ctx->name_offsets = name_offsets;
    ctx->content_cap = content_cap; ctx->norm_flags = norm_flags;
    ctx->seg_data = seg_data; ctx->seg_offsets = seg_offsets;
    ctx->seg_counts = seg_counts; ctx->starts_wild = starts_wild;
    ctx->ends_wild = ends_wild; ctx->n_templates = n_templates;
    ctx->tmpl_data = tmpl_data; ctx->tmpl_offsets = tmpl_offsets;
    ctx->max_caps = max_caps;
    ctx->version = version; ctx->version_len = version_len;
    ctx->parser_type = parser_type; ctx->parser_type_len = parser_type_len;
    ctx->parser_id = parser_id; ctx->parser_id_len = parser_id_len;
    ctx->now = now; ctx->rand_hex = rand_hex;
    ctx->out_buf = out_buf; ctx->out_cap = out_cap;
    ctx->o = 0;
    ctx->scratch = NULL; ctx->scratch_cap = 0;
    ctx->tcaps = (int32_t *)malloc(sizeof(int32_t) * 2
                                   * (size_t)(max_caps > 0 ? max_caps : 1));
    return ctx->tcaps ? 0 : -2;    /* malloc failure: OOM, not capacity */
}

static void parse_ctx_free(parse_ctx_t *ctx) {
    free(ctx->scratch);
    free(ctx->tcaps);
}

int64_t dm_parse_batch(
    const uint8_t *payloads, const int64_t *offsets, int n, PARSE_CTX_ARGS,
    int64_t *out_offsets, int8_t *status)
{
    parse_ctx_t ctx;
    if (parse_ctx_init(&ctx, accept_raw, lit_data, lit_offsets, n_lits,
                       name_data, name_offsets, content_cap, norm_flags,
                       seg_data, seg_offsets, seg_counts, starts_wild,
                       ends_wild, n_templates, tmpl_data, tmpl_offsets,
                       max_caps, version, version_len, parser_type,
                       parser_type_len, parser_id, parser_id_len, now,
                       rand_hex, out_buf, out_cap) != 0)
        return -2;
    out_offsets[0] = 0;
    for (int i = 0; i < n; i++) {
        int rc = parse_one_row(&ctx, payloads + offsets[i],
                               (int)(offsets[i + 1] - offsets[i]), i,
                               status + i);
        if (rc != 0) {
            parse_ctx_free(&ctx);
            return rc;                 /* -1 grow-and-retry, -2 OOM */
        }
        out_offsets[i + 1] = ctx.o;
    }
    int64_t used = ctx.o;
    parse_ctx_free(&ctx);
    return used;
}

/* Frames variant: parse every message of every (pre-validated, via
 * dm_count_frame_msgs) frame straight out of the wire blob. Also fills
 * spans[2m..] = [start, end) byte offsets of each message into the frames
 * blob, so the Python fallback path can slice flagged rows lazily —
 * the engine loop holds no per-message Python objects in parser services
 * either, completing the round-3 detector story. */
int64_t dm_parse_frames(
    const uint8_t *frames, const int64_t *frame_offsets, int n_frames,
    const int32_t *counts, const uint8_t *corrupt, PARSE_CTX_ARGS,
    int64_t *spans, int64_t *out_offsets, int8_t *status)
{
    parse_ctx_t ctx;
    if (parse_ctx_init(&ctx, accept_raw, lit_data, lit_offsets, n_lits,
                       name_data, name_offsets, content_cap, norm_flags,
                       seg_data, seg_offsets, seg_counts, starts_wild,
                       ends_wild, n_templates, tmpl_data, tmpl_offsets,
                       max_caps, version, version_len, parser_type,
                       parser_type_len, parser_id, parser_id_len, now,
                       rand_hex, out_buf, out_cap) != 0)
        return -2;
    out_offsets[0] = 0;
    int64_t m = 0;
    for (int i = 0; i < n_frames; i++) {
        const uint8_t *base = frames + frame_offsets[i];
        int len = (int)(frame_offsets[i + 1] - frame_offsets[i]);
        if (corrupt[i] || counts[i] == 0) continue;
        if (!frame_is_batch(base, len)) {
            spans[2 * m] = frame_offsets[i];
            spans[2 * m + 1] = frame_offsets[i + 1];
            int rc = parse_one_row(&ctx, base, len, m, status + m);
            if (rc != 0) {
                parse_ctx_free(&ctx);
                return rc;
            }
            out_offsets[m + 1] = ctx.o;
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
                int rc = parse_one_row(&ctx, c.p, (int)mlen, m, status + m);
                if (rc != 0) {
                    parse_ctx_free(&ctx);
                    return rc;
                }
                out_offsets[m + 1] = ctx.o;
                m++;
            }
            c.p += mlen;
        }
    }
    int64_t used = ctx.o;
    parse_ctx_free(&ctx);
    return used;
}

/* ---------------- native LogSchema decode (dm_parse_logs_*) ----------------
 *
 * Decode-ONLY twin of parse_one_row's step 1: resolve each ingest payload
 * to its (log, logID) field byte spans without constructing a pb2 object —
 * the host path's remaining per-row Python protobuf crossing. The spans are
 * handed to Python as SpanRaws-style lazy views (utils/matchkern.LogsView):
 * MatcherParser's batched path slices a str per field straight out of the
 * wire blob only when it actually needs one, and the rest of the row
 * (header extraction, time conversion, template match) proceeds on those
 * strings while serialization goes back through dm_emit_parser_rows.
 *
 * Status codes (one-sided contract, same philosophy as dm_parse_batch):
 *   1  envelope — the payload parses as a LogSchema protobuf (strict mode:
 *      any parse; accept_raw: parse AND field presence) and every declared
 *      string field is valid UTF-8; spans point at the log / logID fields
 *      (empty spans when absent, like proto3 defaults).
 *   2  raw line (accept_raw only) — not an envelope, not JSON; the log span
 *      is the payload minus ONE trailing newline (single_value add_newline),
 *      logID empty. Python decodes the span with errors="replace", exactly
 *      like decode_ingest_payload's bare-line shape.
 *   0  JSON record (accept_raw, payload starts with '{') — Python applies
 *      json.loads + the field mapping; no pb2 object is needed there either.
 *  -1  Python fallback — strict-mode parse failure (Python raises/counts
 *      the exact error) or any row this walk cannot classify with parity.
 */

static int8_t decode_one_log(const uint8_t *pay, int pay_len, int accept_raw,
                             int64_t *log_s, int64_t *log_e,
                             int64_t *id_s, int64_t *id_e) {
    const uint8_t *log = NULL; int log_len = 0;
    const uint8_t *log_id = NULL; int log_id_len = 0;
    int presence = 0, parse_ok = 1;
    cursor_t c = { pay, pay + pay_len };
    *log_s = *log_e = *id_s = *id_e = 0;
    while (c.p < c.end) {
        uint64_t tag;
        if (!read_varint(&c, &tag)) { parse_ok = 0; break; }
        uint32_t field = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
        if (field == 0) { parse_ok = 0; break; }
        if (wt == 2 && (field == 2 || field == 3)) {
            uint64_t l;
            if (!read_varint(&c, &l) || (uint64_t)(c.end - c.p) < l) { parse_ok = 0; break; }
            /* upb validates UTF-8 on declared strings at parse time */
            if (!utf8_valid(c.p, (int)l)) { parse_ok = 0; break; }
            if (field == 2) { log_id = c.p; log_id_len = (int)l; }
            else { log = c.p; log_len = (int)l; }
            c.p += l;
            presence = 1;
        } else if (wt == 2 && field >= 1 && field <= 5) {
            /* declared strings 1-5 all count for presence and all get the
             * parse-time UTF-8 check (same discipline as parse_one_row) */
            uint64_t l;
            if (!read_varint(&c, &l) || (uint64_t)(c.end - c.p) < l) { parse_ok = 0; break; }
            if (!utf8_valid(c.p, (int)l)) { parse_ok = 0; break; }
            c.p += l;
            presence = 1;
        } else {
            if (!skip_field(&c, wt)) { parse_ok = 0; break; }
        }
    }
    if (parse_ok && (!accept_raw || presence)) {
        if (log != NULL) { *log_s = log - pay; *log_e = *log_s + log_len; }
        if (log_id != NULL) { *id_s = log_id - pay; *id_e = *id_s + log_id_len; }
        return 1;
    }
    if (!accept_raw)
        return -1;                /* strict parse failure: Python raises */
    if (pay_len > 0 && pay[0] == '{')
        return 0;                 /* JSON record: Python's json path */
    *log_s = 0;
    *log_e = pay_len;
    if (pay_len > 0 && pay[pay_len - 1] == '\n')
        *log_e = pay_len - 1;     /* single_value's add_newline */
    return 2;
}

/* Batch variant over a packed payload blob: fspans[4i..4i+3] are ABSOLUTE
 * [log_start, log_end, id_start, id_end) offsets into `payloads`. */
void dm_parse_logs_batch(const uint8_t *payloads, const int64_t *offsets,
                         int n, int accept_raw,
                         int64_t *fspans, int8_t *status) {
    for (int i = 0; i < n; i++) {
        int64_t ls, le, is_, ie;
        status[i] = decode_one_log(payloads + offsets[i],
                                   (int)(offsets[i + 1] - offsets[i]),
                                   accept_raw, &ls, &le, &is_, &ie);
        fspans[4 * i + 0] = offsets[i] + ls;
        fspans[4 * i + 1] = offsets[i] + le;
        fspans[4 * i + 2] = offsets[i] + is_;
        fspans[4 * i + 3] = offsets[i] + ie;
    }
}

/* Frames variant: expand (pre-validated via dm_count_frame_msgs) wire
 * frames and decode every contained message. spans[2m..] = payload byte
 * spans, fspans[4m..] = field spans, both absolute into `frames`.
 * Returns the message count written. */
int64_t dm_parse_logs_frames(const uint8_t *frames, const int64_t *frame_offsets,
                             int n_frames, const int32_t *counts,
                             const uint8_t *corrupt, int accept_raw,
                             int64_t *spans, int64_t *fspans, int8_t *status) {
    int64_t m = 0;
    for (int i = 0; i < n_frames; i++) {
        const uint8_t *base = frames + frame_offsets[i];
        int len = (int)(frame_offsets[i + 1] - frame_offsets[i]);
        if (corrupt[i] || counts[i] == 0) continue;
        if (!frame_is_batch(base, len)) {
            int64_t ls, le, is_, ie;
            spans[2 * m] = frame_offsets[i];
            spans[2 * m + 1] = frame_offsets[i + 1];
            status[m] = decode_one_log(base, len, accept_raw,
                                       &ls, &le, &is_, &ie);
            fspans[4 * m + 0] = frame_offsets[i] + ls;
            fspans[4 * m + 1] = frame_offsets[i] + le;
            fspans[4 * m + 2] = frame_offsets[i] + is_;
            fspans[4 * m + 3] = frame_offsets[i] + ie;
            m++;
            continue;
        }
        cursor_t c = { base + 4, base + len };
        uint64_t n_msgs;
        read_varint(&c, &n_msgs);          /* pre-validated by the count pass */
        for (uint64_t k = 0; k < n_msgs; k++) {
            uint64_t mlen;
            read_varint(&c, &mlen);
            if (mlen > 0) {                /* packed empties: filtered */
                int64_t ls, le, is_, ie;
                int64_t pay_off = frame_offsets[i] + (c.p - base);
                spans[2 * m] = pay_off;
                spans[2 * m + 1] = pay_off + (int64_t)mlen;
                status[m] = decode_one_log(c.p, (int)mlen, accept_raw,
                                           &ls, &le, &is_, &ie);
                fspans[4 * m + 0] = pay_off + ls;
                fspans[4 * m + 1] = pay_off + le;
                fspans[4 * m + 2] = pay_off + is_;
                fspans[4 * m + 3] = pay_off + ie;
                m++;
            }
            c.p += mlen;
        }
    }
    return m;
}

/* ---------------- native ParserSchema emit (dm_emit_parser_rows) ----------
 *
 * Serialize n ParserSchema rows into the caller's reusable output arena,
 * byte-identical to pb2 SerializeToString over the same fields — the SAME
 * emit order and encoders as parse_one_row (whose output parity is pinned
 * by the differential fuzzer), but driven by field data Python computed
 * (header extraction / time conversion / template match), so the batched
 * Python path stops paying a pb2 object + SerializeToString per row.
 *
 * Per-row inputs ride packed blobs with prefix-offset arrays; var_counts /
 * kv_counts give each row's slice of the shared variables / map arrays
 * (running index, no per-row offset table needed). Map entries arrive
 * ALREADY deduplicated in dict insertion order — Python's dict semantics
 * are the one home for last-wins there.
 *
 * Returns bytes used, or -1 when `cap` is insufficient (the binding grows
 * the arena and retries — same contract as dm_parse_batch).
 */
int64_t dm_emit_parser_rows(
    int n, const int32_t *event_ids,
    const uint8_t *tmpl_blob, const int64_t *tmpl_offs,
    const uint8_t *var_blob, const int64_t *var_offs, const int32_t *var_counts,
    const uint8_t *id_blob, const int64_t *id_offs,
    const uint8_t *key_blob, const int64_t *key_offs,
    const uint8_t *val_blob, const int64_t *val_offs, const int32_t *kv_counts,
    const uint8_t *version, int version_len,
    const uint8_t *parser_type, int parser_type_len,
    const uint8_t *parser_id, int parser_id_len,
    const uint8_t *rand_hex, const int64_t *recv_ts, const int64_t *parsed_ts,
    uint8_t *out, int64_t cap, int64_t *out_offsets)
{
    int64_t o = 0;
    int64_t vi = 0, ki = 0;            /* running variable / map-entry index */
    out_offsets[0] = 0;
    for (int i = 0; i < n; i++) {
        int nv = var_counts[i], nk = kv_counts[i];
        int64_t tmpl_len = tmpl_offs[i + 1] - tmpl_offs[i];
        int64_t id_len = id_offs[i + 1] - id_offs[i];
        int64_t vars_len = var_offs[vi + nv] - var_offs[vi];
        int64_t kv_len = (key_offs[ki + nk] - key_offs[ki])
            + (val_offs[ki + nk] - val_offs[ki]);
        int64_t bound = 64 + version_len + parser_type_len + 2 * parser_id_len
            + tmpl_len + vars_len + 32 + id_len + kv_len
            + 16LL * (nv + nk) + 20;
        if (o + bound > cap) return -1;
        o = emit_str(out, o, 1, version, version_len);
        o = emit_str(out, o, 2, parser_type, parser_type_len);
        o = emit_str(out, o, 3, parser_id, parser_id_len);
        o = emit_i32(out, o, 4, event_ids[i]);
        o = emit_str(out, o, 5, tmpl_blob + tmpl_offs[i], (int)tmpl_len);
        for (int k = 0; k < nv; k++, vi++)
            o = emit_str(out, o, 6, var_blob + var_offs[vi],
                         (int)(var_offs[vi + 1] - var_offs[vi]));
        o = emit_str(out, o, 7, rand_hex + (int64_t)i * 32, 32);
        o = emit_str(out, o, 8, id_blob + id_offs[i], (int)id_len);
        /* reference quirk: `log` carries the parser name, not the line */
        o = emit_str(out, o, 9, parser_id, parser_id_len);
        for (int k = 0; k < nk; k++, ki++) {
            int key_len = (int)(key_offs[ki + 1] - key_offs[ki]);
            int val_len = (int)(val_offs[ki + 1] - val_offs[ki]);
            int64_t sub_len = 1 + varint_size((uint64_t)key_len) + key_len
                + 1 + varint_size((uint64_t)val_len) + val_len;
            o = emit_varint(out, o, (10u << 3) | 2);
            o = emit_varint(out, o, (uint64_t)sub_len);
            o = emit_str(out, o, 1, key_blob + key_offs[ki], key_len);
            o = emit_str(out, o, 2, val_blob + val_offs[ki], val_len);
        }
        o = emit_i32(out, o, 11, (int32_t)recv_ts[i]);
        o = emit_i32(out, o, 12, (int32_t)parsed_ts[i]);
        out_offsets[i + 1] = o;
    }
    return o;
}

