/* rtmsg_client — a non-Python speaker of the control-plane wire protocol.
 *
 * Reference analog: the reference's Java/C++ workers all speak the same
 * protobuf control protocol as Python (src/ray/protobuf/ +
 * src/ray/rpc/); this client is the rebuild's existence proof that the
 * L0 wire contract (_private/wire.py) is genuinely language-neutral:
 *
 *   - multiprocessing.connection transport framing (4-byte big-endian
 *     length prefix per message, CPython >= 3.3);
 *   - the mutual HMAC authentication handshake, BOTH schemes: the
 *     CPython 3.12 modern one ("{sha256}" digest prefixes, HMAC over
 *     the whole post-#CHALLENGE# message) and the legacy <=3.11 one
 *     (raw HMAC-MD5 over the challenge bytes).  The scheme is detected
 *     from the server's own challenge ('{' prefix or not), so the
 *     digest is always derived over the same canonical bytes the
 *     CPython peer uses — see auth_handshake;
 *   - `[version u8][codec u8]` frames with the rtmsg tag codec
 *     (wire.py's tag table) — NO pickle anywhere in this file;
 *   - version negotiation via __proto_hello__, then kv_put / kv_get /
 *     export_function / submit_task / get_meta RPCs against a live head.
 *
 * Usage:
 *   rtmsg_client <socket_path> <authkey_hex> kv <key> <value>
 *       negotiate v2, kv_put <key>=<value>, kv_get it back, print it.
 *   rtmsg_client <socket_path> <authkey_hex> submit <client_id> \
 *       <fn_id> <fn_blob_file> <task_id> <return_id> <values_blob_file>
 *       negotiate, export_function(blob), submit_task (no-arg spec),
 *       block in get_meta until the return object seals, print state.
 *
 * The two blob files carry opaque Python payloads (a cloudpickled
 * function, a serialized empty-args tuple) produced by the test — the
 * client treats them as bytes, exactly as a reference C++ worker treats
 * a language-specific task payload it routes but does not execute.
 *
 * Exit 0 on success; nonzero with a message on stderr otherwise.
 */

#include <arpa/inet.h>
#include <errno.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <time.h>
#include <unistd.h>

/* ------------------------------------------------------------- SHA-256 */
/* Public-domain style compact SHA-256 (FIPS 180-4). */
typedef struct { uint32_t h[8]; uint64_t len; uint8_t buf[64]; size_t n; } sha256_t;

static const uint32_t K256[64] = {
    0x428a2f98,0x71374491,0xb5c0fbcf,0xe9b5dba5,0x3956c25b,0x59f111f1,
    0x923f82a4,0xab1c5ed5,0xd807aa98,0x12835b01,0x243185be,0x550c7dc3,
    0x72be5d74,0x80deb1fe,0x9bdc06a7,0xc19bf174,0xe49b69c1,0xefbe4786,
    0x0fc19dc6,0x240ca1cc,0x2de92c6f,0x4a7484aa,0x5cb0a9dc,0x76f988da,
    0x983e5152,0xa831c66d,0xb00327c8,0xbf597fc7,0xc6e00bf3,0xd5a79147,
    0x06ca6351,0x14292967,0x27b70a85,0x2e1b2138,0x4d2c6dfc,0x53380d13,
    0x650a7354,0x766a0abb,0x81c2c92e,0x92722c85,0xa2bfe8a1,0xa81a664b,
    0xc24b8b70,0xc76c51a3,0xd192e819,0xd6990624,0xf40e3585,0x106aa070,
    0x19a4c116,0x1e376c08,0x2748774c,0x34b0bcb5,0x391c0cb3,0x4ed8aa4a,
    0x5b9cca4f,0x682e6ff3,0x748f82ee,0x78a5636f,0x84c87814,0x8cc70208,
    0x90befffa,0xa4506ceb,0xbef9a3f7,0xc67178f2};

#define ROR(x,n) (((x) >> (n)) | ((x) << (32 - (n))))

static void sha256_init(sha256_t *s) {
    static const uint32_t h0[8] = {
        0x6a09e667,0xbb67ae85,0x3c6ef372,0xa54ff53a,
        0x510e527f,0x9b05688c,0x1f83d9ab,0x5be0cd19};
    memcpy(s->h, h0, sizeof h0);
    s->len = 0; s->n = 0;
}

static void sha256_block(sha256_t *s, const uint8_t *p) {
    uint32_t w[64], a, b, c, d, e, f, g, h;
    int i;
    for (i = 0; i < 16; i++)
        w[i] = (uint32_t)p[4*i] << 24 | (uint32_t)p[4*i+1] << 16 |
               (uint32_t)p[4*i+2] << 8 | p[4*i+3];
    for (; i < 64; i++) {
        uint32_t s0 = ROR(w[i-15],7) ^ ROR(w[i-15],18) ^ (w[i-15] >> 3);
        uint32_t s1 = ROR(w[i-2],17) ^ ROR(w[i-2],19) ^ (w[i-2] >> 10);
        w[i] = w[i-16] + s0 + w[i-7] + s1;
    }
    a=s->h[0]; b=s->h[1]; c=s->h[2]; d=s->h[3];
    e=s->h[4]; f=s->h[5]; g=s->h[6]; h=s->h[7];
    for (i = 0; i < 64; i++) {
        uint32_t S1 = ROR(e,6) ^ ROR(e,11) ^ ROR(e,25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = h + S1 + ch + K256[i] + w[i];
        uint32_t S0 = ROR(a,2) ^ ROR(a,13) ^ ROR(a,22);
        uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
        uint32_t t2 = S0 + mj;
        h=g; g=f; f=e; e=d+t1; d=c; c=b; b=a; a=t1+t2;
    }
    s->h[0]+=a; s->h[1]+=b; s->h[2]+=c; s->h[3]+=d;
    s->h[4]+=e; s->h[5]+=f; s->h[6]+=g; s->h[7]+=h;
}

static void sha256_update(sha256_t *s, const void *data, size_t len) {
    const uint8_t *p = (const uint8_t *)data;
    s->len += len;
    while (len) {
        size_t take = 64 - s->n;
        if (take > len) take = len;
        memcpy(s->buf + s->n, p, take);
        s->n += take; p += take; len -= take;
        if (s->n == 64) { sha256_block(s, s->buf); s->n = 0; }
    }
}

static void sha256_final(sha256_t *s, uint8_t out[32]) {
    uint64_t bits = s->len * 8;
    uint8_t pad = 0x80;
    uint8_t lenb[8];
    int i;
    sha256_update(s, &pad, 1);
    while (s->n != 56) { uint8_t z = 0; sha256_update(s, &z, 1); }
    for (i = 0; i < 8; i++) lenb[i] = (uint8_t)(bits >> (56 - 8*i));
    sha256_update(s, lenb, 8);
    for (i = 0; i < 8; i++) {
        out[4*i]   = (uint8_t)(s->h[i] >> 24);
        out[4*i+1] = (uint8_t)(s->h[i] >> 16);
        out[4*i+2] = (uint8_t)(s->h[i] >> 8);
        out[4*i+3] = (uint8_t)(s->h[i]);
    }
}

static void hmac_sha256(const uint8_t *key, size_t keylen,
                        const uint8_t *msg, size_t msglen, uint8_t out[32]) {
    uint8_t k[64], ipad[64], opad[64], inner[32];
    sha256_t s;
    size_t i;
    memset(k, 0, sizeof k);
    if (keylen > 64) { sha256_init(&s); sha256_update(&s, key, keylen); sha256_final(&s, k); }
    else memcpy(k, key, keylen);
    for (i = 0; i < 64; i++) { ipad[i] = k[i] ^ 0x36; opad[i] = k[i] ^ 0x5c; }
    sha256_init(&s); sha256_update(&s, ipad, 64);
    sha256_update(&s, msg, msglen); sha256_final(&s, inner);
    sha256_init(&s); sha256_update(&s, opad, 64);
    sha256_update(&s, inner, 32); sha256_final(&s, out);
}

/* ------------------------------------------------------------- MD5 */
/* Compact MD5 (RFC 1321) — needed for the legacy (<=3.11) CPython
 * multiprocessing handshake, which is raw HMAC-MD5. */
typedef struct { uint32_t h[4]; uint64_t len; uint8_t buf[64]; size_t n; } md5_t;

static const uint32_t K_MD5[64] = {
    0xd76aa478,0xe8c7b756,0x242070db,0xc1bdceee,0xf57c0faf,0x4787c62a,
    0xa8304613,0xfd469501,0x698098d8,0x8b44f7af,0xffff5bb1,0x895cd7be,
    0x6b901122,0xfd987193,0xa679438e,0x49b40821,0xf61e2562,0xc040b340,
    0x265e5a51,0xe9b6c7aa,0xd62f105d,0x02441453,0xd8a1e681,0xe7d3fbc8,
    0x21e1cde6,0xc33707d6,0xf4d50d87,0x455a14ed,0xa9e3e905,0xfcefa3f8,
    0x676f02d9,0x8d2a4c8a,0xfffa3942,0x8771f681,0x6d9d6122,0xfde5380c,
    0xa4beea44,0x4bdecfa9,0xf6bb4b60,0xbebfbc70,0x289b7ec6,0xeaa127fa,
    0xd4ef3085,0x04881d05,0xd9d4d039,0xe6db99e5,0x1fa27cf8,0xc4ac5665,
    0xf4292244,0x432aff97,0xab9423a7,0xfc93a039,0x655b59c3,0x8f0ccc92,
    0xffeff47d,0x85845dd1,0x6fa87e4f,0xfe2ce6e0,0xa3014314,0x4e0811a1,
    0xf7537e82,0xbd3af235,0x2ad7d2bb,0xeb86d391};
static const uint8_t S_MD5[64] = {
    7,12,17,22,7,12,17,22,7,12,17,22,7,12,17,22,
    5,9,14,20,5,9,14,20,5,9,14,20,5,9,14,20,
    4,11,16,23,4,11,16,23,4,11,16,23,4,11,16,23,
    6,10,15,21,6,10,15,21,6,10,15,21,6,10,15,21};

static void md5_block(md5_t *s, const uint8_t *p) {
    uint32_t M[16], A = s->h[0], B = s->h[1], C = s->h[2], D = s->h[3];
    int i;
    for (i = 0; i < 16; i++)
        M[i] = (uint32_t)p[i*4] | ((uint32_t)p[i*4+1] << 8) |
               ((uint32_t)p[i*4+2] << 16) | ((uint32_t)p[i*4+3] << 24);
    for (i = 0; i < 64; i++) {
        uint32_t F;
        int g;
        if (i < 16)      { F = (B & C) | (~B & D); g = i; }
        else if (i < 32) { F = (D & B) | (~D & C); g = (5*i + 1) % 16; }
        else if (i < 48) { F = B ^ C ^ D;          g = (3*i + 5) % 16; }
        else             { F = C ^ (B | ~D);       g = (7*i) % 16; }
        F += A + K_MD5[i] + M[g];
        A = D; D = C; C = B;
        B += (F << S_MD5[i]) | (F >> (32 - S_MD5[i]));
    }
    s->h[0] += A; s->h[1] += B; s->h[2] += C; s->h[3] += D;
}

static void md5_init(md5_t *s) {
    s->h[0] = 0x67452301; s->h[1] = 0xefcdab89;
    s->h[2] = 0x98badcfe; s->h[3] = 0x10325476;
    s->len = 0; s->n = 0;
}

static void md5_update(md5_t *s, const void *data, size_t len) {
    const uint8_t *p = (const uint8_t *)data;
    s->len += (uint64_t)len * 8;
    while (len) {
        size_t t = 64 - s->n;
        if (t > len) t = len;
        memcpy(s->buf + s->n, p, t);
        s->n += t; p += t; len -= t;
        if (s->n == 64) { md5_block(s, s->buf); s->n = 0; }
    }
}

static void md5_final(md5_t *s, uint8_t out[16]) {
    uint64_t bits = s->len;
    uint8_t pad = 0x80, zero = 0, lenb[8];
    int i;
    /* `bits` was captured above, so the padding updates below may touch
     * s->len freely. */
    md5_update(s, &pad, 1);
    while (s->n != 56) md5_update(s, &zero, 1);
    for (i = 0; i < 8; i++) lenb[i] = (uint8_t)(bits >> (8 * i));
    md5_update(s, lenb, 8);
    for (i = 0; i < 4; i++) {
        out[i*4]   = (uint8_t)(s->h[i]);
        out[i*4+1] = (uint8_t)(s->h[i] >> 8);
        out[i*4+2] = (uint8_t)(s->h[i] >> 16);
        out[i*4+3] = (uint8_t)(s->h[i] >> 24);
    }
}

static void hmac_md5(const uint8_t *key, size_t keylen,
                     const uint8_t *msg, size_t msglen, uint8_t out[16]) {
    uint8_t k[64] = {0}, ipad[64], opad[64], inner[16];
    md5_t s;
    size_t i;
    if (keylen > 64) { md5_init(&s); md5_update(&s, key, keylen); md5_final(&s, k); }
    else memcpy(k, key, keylen);
    for (i = 0; i < 64; i++) { ipad[i] = k[i] ^ 0x36; opad[i] = k[i] ^ 0x5c; }
    md5_init(&s); md5_update(&s, ipad, 64);
    md5_update(&s, msg, msglen); md5_final(&s, inner);
    md5_init(&s); md5_update(&s, opad, 64);
    md5_update(&s, inner, 16); md5_final(&s, out);
}

/* -------------------------------------------- mp.connection transport */
static int xread(int fd, void *buf, size_t n) {
    uint8_t *p = (uint8_t *)buf;
    while (n) {
        ssize_t r = read(fd, p, n);
        if (r <= 0) { if (r < 0 && errno == EINTR) continue; return -1; }
        p += r; n -= (size_t)r;
    }
    return 0;
}

static int xwrite(int fd, const void *buf, size_t n) {
    const uint8_t *p = (const uint8_t *)buf;
    while (n) {
        ssize_t r = write(fd, p, n);
        if (r < 0) { if (errno == EINTR) continue; return -1; }
        p += r; n -= (size_t)r;
    }
    return 0;
}

static int send_msg(int fd, const uint8_t *body, uint32_t n) {
    uint32_t be = htonl(n);
    if (xwrite(fd, &be, 4)) return -1;
    return xwrite(fd, body, n);
}

/* Returns malloc'd buffer; caller frees.  Handles the -1 + u64 large-
 * message escape even though control messages never need it. */
static uint8_t *recv_msg(int fd, uint32_t *out_n) {
    uint32_t be;
    int32_t n;
    uint64_t big;
    uint8_t *buf;
    if (xread(fd, &be, 4)) return NULL;
    n = (int32_t)ntohl(be);
    if (n == -1) {
        if (xread(fd, &big, 8)) return NULL;
        big = be64toh(big);
        if (big > (1u << 30)) return NULL;
        n = (int32_t)big;
    }
    if (n < 0 || n > (1 << 30)) return NULL;
    buf = (uint8_t *)malloc((size_t)n ? (size_t)n : 1);
    if (!buf) return NULL;
    if (xread(fd, buf, (size_t)n)) { free(buf); return NULL; }
    *out_n = (uint32_t)n;
    return buf;
}

static int urandom(uint8_t *out, size_t n) {
    FILE *f = fopen("/dev/urandom", "rb");
    if (!f) return -1;
    size_t got = fread(out, 1, n, f);
    fclose(f);
    return got == n ? 0 : -1;
}

/* Mutual auth: answer the server's challenge, then issue ours.
 * (CPython: Client() = answer_challenge + deliver_challenge.)
 *
 * Two wire schemes exist and the digest must cover the SAME canonical
 * bytes on both sides:
 *
 *   modern (3.12+): the post-#CHALLENGE# message begins with a
 *     "{digest}" name prefix and the HMAC covers the WHOLE post-
 *     #CHALLENGE# message, prefix included; the response carries the
 *     same "{digest}" prefix.
 *   legacy (<=3.11): the post-#CHALLENGE# message is raw random bytes,
 *     the HMAC is MD5 over exactly those bytes, and the response is the
 *     bare 16-byte digest.
 *
 * The server speaks first, so its challenge tells us which scheme this
 * CPython uses ('{' or not); we answer — and then deliver our own
 * challenge — in that same scheme. */
static int auth_handshake(int fd, const uint8_t *key, size_t keylen) {
    static const char CHAL[] = "#CHALLENGE#";
    static const char PFX[] = "{sha256}";
    uint32_t n;
    uint8_t *m = recv_msg(fd, &n);
    uint8_t mac[32], reply[8 + 32], chal[11 + 8 + 32], *resp;
    int legacy;
    if (!m || n < sizeof(CHAL) - 1 ||
        memcmp(m, CHAL, sizeof(CHAL) - 1) != 0) {
        fprintf(stderr, "auth: bad challenge\n"); free(m); return -1;
    }
    /* Scheme detection must validate the whole "{sha256}" digest-name
     * prefix, not just the '{' byte: a legacy server's challenge is
     * os.urandom() and starts with 0x7b once in 256 handshakes.
     * (CPython's answer_challenge equally requires a closing '}' and a
     * known digest name before leaving legacy mode.)  A modern server
     * always sends exactly "{sha256}" (deliver_challenge's default and
     * the only digest this client implements). */
    legacy = (n < sizeof(CHAL) - 1 + sizeof(PFX) - 1) ||
        memcmp(m + sizeof(CHAL) - 1, PFX, sizeof(PFX) - 1) != 0;
    if (legacy) {
        /* canonical bytes: the raw challenge payload; digest: HMAC-MD5 */
        hmac_md5(key, keylen, m + sizeof(CHAL) - 1,
                 n - (sizeof(CHAL) - 1), mac);
        free(m);
        if (send_msg(fd, mac, 16)) return -1;
    } else {
        /* canonical bytes: the whole post-#CHALLENGE# message including
         * the "{sha256}" prefix; digest: HMAC-SHA256, prefixed reply */
        hmac_sha256(key, keylen, m + sizeof(CHAL) - 1,
                    n - (sizeof(CHAL) - 1), mac);
        free(m);
        memcpy(reply, PFX, 8);
        memcpy(reply + 8, mac, 32);
        if (send_msg(fd, reply, sizeof reply)) return -1;
    }
    m = recv_msg(fd, &n);
    if (!m || n != 9 || memcmp(m, "#WELCOME#", 9) != 0) {
        fprintf(stderr, "auth: digest rejected\n"); free(m); return -1;
    }
    free(m);
    /* Our challenge back at the server, in the scheme it speaks. */
    if (legacy) {
        memcpy(chal, CHAL, 11);
        if (urandom(chal + 11, 20)) return -1;
        if (send_msg(fd, chal, 11 + 20)) return -1;
        resp = recv_msg(fd, &n);
        if (!resp) return -1;
        hmac_md5(key, keylen, chal + 11, 20, mac);
        if (n != 16 || memcmp(resp, mac, 16) != 0) {
            send_msg(fd, (const uint8_t *)"#FAILURE#", 9);
            fprintf(stderr, "auth: server failed our challenge\n");
            free(resp); return -1;
        }
    } else {
        memcpy(chal, CHAL, 11);
        memcpy(chal + 11, PFX, 8);
        if (urandom(chal + 19, 32)) return -1;
        if (send_msg(fd, chal, sizeof chal)) return -1;
        resp = recv_msg(fd, &n);
        if (!resp) return -1;
        hmac_sha256(key, keylen, chal + 11, sizeof chal - 11, mac);
        /* Modern responder replies "{digest}" + mac; sha256 only. */
        if (n != 8 + 32 || memcmp(resp, PFX, 8) != 0 ||
            memcmp(resp + 8, mac, 32) != 0) {
            send_msg(fd, (const uint8_t *)"#FAILURE#", 9);
            fprintf(stderr, "auth: server failed our challenge\n");
            free(resp); return -1;
        }
    }
    free(resp);
    return send_msg(fd, (const uint8_t *)"#WELCOME#", 9);
}

/* ------------------------------------------------------- rtmsg encode */
typedef struct { uint8_t *p; size_t n, cap; } buf_t;

static void b_grow(buf_t *b, size_t add) {
    if (b->n + add <= b->cap) return;
    while (b->cap < b->n + add) b->cap = b->cap ? b->cap * 2 : 256;
    b->p = (uint8_t *)realloc(b->p, b->cap);
}

static void b_u8(buf_t *b, uint8_t v) { b_grow(b, 1); b->p[b->n++] = v; }

static void b_u32(buf_t *b, uint32_t v) {
    b_grow(b, 4);
    b->p[b->n++] = (uint8_t)(v >> 24); b->p[b->n++] = (uint8_t)(v >> 16);
    b->p[b->n++] = (uint8_t)(v >> 8);  b->p[b->n++] = (uint8_t)v;
}

static void b_raw(buf_t *b, const void *p, size_t n) {
    b_grow(b, n); memcpy(b->p + b->n, p, n); b->n += n;
}

static void enc_none(buf_t *b) { b_u8(b, 0x01); }
static void enc_bool(buf_t *b, int v) { b_u8(b, v ? 0x03 : 0x02); }

static void enc_i64(buf_t *b, int64_t v) {
    int i;
    b_u8(b, 0x10);
    for (i = 7; i >= 0; i--) b_u8(b, (uint8_t)((uint64_t)v >> (8 * i)));
}

static void enc_str(buf_t *b, const char *s) {
    size_t n = strlen(s);
    b_u8(b, 0x20); b_u32(b, (uint32_t)n); b_raw(b, s, n);
}

static void enc_bytes(buf_t *b, const uint8_t *p, size_t n) {
    b_u8(b, 0x21); b_u32(b, (uint32_t)n); b_raw(b, p, n);
}

static void enc_list(buf_t *b, uint32_t count) { b_u8(b, 0x30); b_u32(b, count); }
static void enc_dict(buf_t *b, uint32_t count) { b_u8(b, 0x32); b_u32(b, count); }

/* Frame + ship: [version=2][codec=1 rtmsg] + body. */
static int send_frame(int fd, const buf_t *body) {
    buf_t f = {0};
    int rc;
    b_u8(&f, 2); b_u8(&f, 1);
    b_raw(&f, body->p, body->n);
    rc = send_msg(fd, f.p, (uint32_t)f.n);
    free(f.p);
    return rc;
}

/* ------------------------------------------------------- rtmsg decode */
/* Minimal cursor decoder; the client only needs to WALK replies and pull
 * out a few fields, so values are surfaced as tagged views. */
typedef struct {
    uint8_t tag;             /* wire tag */
    int64_t i;               /* 0x10, and bool as 0/1 */
    double f;                /* 0x11 */
    const uint8_t *data;     /* 0x20/0x21 payload */
    uint32_t len;            /* payload len, or container count */
} val_t;

static int dec_val(const uint8_t *p, uint32_t n, uint32_t *off, val_t *v);

static int dec_u32(const uint8_t *p, uint32_t n, uint32_t *off, uint32_t *out) {
    if (*off + 4 > n) return -1;
    *out = (uint32_t)p[*off] << 24 | (uint32_t)p[*off+1] << 16 |
           (uint32_t)p[*off+2] << 8 | p[*off+3];
    *off += 4;
    return 0;
}

/* Skip one complete value (containers recursively). */
static int dec_skip(const uint8_t *p, uint32_t n, uint32_t *off) {
    val_t v;
    uint32_t i;
    if (dec_val(p, n, off, &v)) return -1;
    if (v.tag == 0x30 || v.tag == 0x31) {
        for (i = 0; i < v.len; i++) if (dec_skip(p, n, off)) return -1;
    } else if (v.tag == 0x32) {
        for (i = 0; i < v.len; i++)
            if (dec_skip(p, n, off) || dec_skip(p, n, off)) return -1;
    }
    return 0;
}

static int dec_val(const uint8_t *p, uint32_t n, uint32_t *off, val_t *v) {
    uint8_t tag;
    int i;
    if (*off >= n) return -1;
    tag = p[(*off)++];
    memset(v, 0, sizeof *v);
    v->tag = tag;
    switch (tag) {
    case 0x01: return 0;
    case 0x02: v->i = 0; return 0;
    case 0x03: v->i = 1; return 0;
    case 0x10:
        if (*off + 8 > n) return -1;
        v->i = 0;
        for (i = 0; i < 8; i++) v->i = (v->i << 8) | p[(*off)++];
        return 0;
    case 0x11: {
        uint64_t u = 0;
        if (*off + 8 > n) return -1;
        for (i = 0; i < 8; i++) u = (u << 8) | p[(*off)++];
        memcpy(&v->f, &u, 8);
        return 0;
    }
    case 0x20: case 0x21:
        if (dec_u32(p, n, off, &v->len)) return -1;
        /* no u32 wrap: compare against the REMAINING bytes */
        if (v->len > n - *off) return -1;
        v->data = p + *off;
        *off += v->len;
        return 0;
    case 0x30: case 0x31: case 0x32:
        return dec_u32(p, n, off, &v->len);   /* count; items follow */
    default:
        return -1;
    }
}

/* In a top-level dict reply, find `key` and leave *off at its value.
 * Returns 0 found / 1 not found / -1 malformed. */
static int dict_find(const uint8_t *p, uint32_t n, const char *key,
                     uint32_t *off, val_t *v) {
    uint32_t o = 0, i;
    val_t d, k;
    if (dec_val(p, n, &o, &d) || d.tag != 0x32) return -1;
    for (i = 0; i < d.len; i++) {
        if (dec_val(p, n, &o, &k)) return -1;
        if (k.tag == 0x20 && k.len == strlen(key) &&
            memcmp(k.data, key, k.len) == 0) {
            *off = o;
            return dec_val(p, n, &o, v) ? -1 : 0;
        }
        if (k.tag == 0x30 || k.tag == 0x31 || k.tag == 0x32) return -1;
        if (dec_skip(p, n, &o)) return -1;   /* skip this key's value */
    }
    return 1;
}

/* recv one reply frame; verify rid and error==None.  Returns body
 * (malloc'd, caller frees) positioned AFTER the 2-byte header. */
static uint8_t *rpc_recv(int fd, int64_t want_rid, uint32_t *out_n) {
    for (;;) {
        uint32_t n, off;
        val_t v;
        uint8_t *m = recv_msg(fd, &n);
        if (!m) { fprintf(stderr, "rpc: recv failed\n"); return NULL; }
        if (n < 2 || m[0] != 2 || m[1] != 1) {
            fprintf(stderr, "rpc: expected v2/rtmsg frame, got "
                    "ver=%d codec=%d (server did not mirror codec?)\n",
                    n ? m[0] : -1, n > 1 ? m[1] : -1);
            free(m);
            return NULL;
        }
        if (dict_find(m + 2, n - 2, "rid", &off, &v) != 0 ||
            v.tag != 0x10 || v.i != want_rid) {
            free(m);            /* stale push/other-rid frame: keep waiting */
            continue;
        }
        if (dict_find(m + 2, n - 2, "error", &off, &v) != 0 || v.tag != 0x01) {
            fprintf(stderr, "rpc: server returned an error (rid=%lld)\n",
                    (long long)want_rid);
            free(m);
            return NULL;
        }
        *out_n = n - 2;
        /* shift body down so callers index from 0 */
        memmove(m, m + 2, n - 2);
        return m;
    }
}

/* ------------------------------------------------------------ helpers */
static int hex2bin(const char *hex, uint8_t **out, size_t *out_n) {
    size_t n = strlen(hex);
    size_t i;
    if (n % 2) return -1;
    *out = (uint8_t *)malloc(n / 2 ? n / 2 : 1);
    for (i = 0; i < n / 2; i++) {
        unsigned b;
        if (sscanf(hex + 2 * i, "%2x", &b) != 1) return -1;
        (*out)[i] = (uint8_t)b;
    }
    *out_n = n / 2;
    return 0;
}

static uint8_t *read_file(const char *path, size_t *out_n) {
    FILE *f = fopen(path, "rb");
    uint8_t *buf;
    long n;
    if (!f) return NULL;
    fseek(f, 0, SEEK_END); n = ftell(f); fseek(f, 0, SEEK_SET);
    buf = (uint8_t *)malloc((size_t)n ? (size_t)n : 1);
    if (fread(buf, 1, (size_t)n, f) != (size_t)n) { fclose(f); free(buf); return NULL; }
    fclose(f);
    *out_n = (size_t)n;
    return buf;
}

static int dial_unix(const char *path) {
    struct sockaddr_un addr;
    int fd = socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    memset(&addr, 0, sizeof addr);
    addr.sun_family = AF_UNIX;
    strncpy(addr.sun_path, path, sizeof addr.sun_path - 1);
    if (connect(fd, (struct sockaddr *)&addr, sizeof addr)) {
        close(fd);
        return -1;
    }
    return fd;
}

/* ---------------------------------------------------------------- RPCs */
static int64_t g_rid = 0;

static int rpc_hello(int fd) {
    buf_t b = {0};
    uint32_t n, off;
    val_t v;
    uint8_t *m;
    int64_t rid = ++g_rid;
    enc_dict(&b, 3);
    enc_str(&b, "kind"); enc_str(&b, "__proto_hello__");
    enc_str(&b, "rid");  enc_i64(&b, rid);
    enc_str(&b, "versions");
    enc_list(&b, 2); enc_i64(&b, 1); enc_i64(&b, 2);
    if (send_frame(fd, &b)) { free(b.p); return -1; }
    free(b.p);
    m = rpc_recv(fd, rid, &n);
    if (!m) return -1;
    if (dict_find(m, n, "proto", &off, &v) != 0 || v.tag != 0x10 || v.i != 2) {
        fprintf(stderr, "hello: expected proto=2\n");
        free(m);
        return -1;
    }
    free(m);
    printf("HELLO proto=2\n");
    return 0;
}

static int rpc_kv_roundtrip(int fd, const char *key, const char *value) {
    buf_t b = {0};
    uint32_t n, off;
    val_t v;
    uint8_t *m;
    int64_t rid = ++g_rid;
    enc_dict(&b, 5);
    enc_str(&b, "kind");  enc_str(&b, "kv_put");
    enc_str(&b, "rid");   enc_i64(&b, rid);
    enc_str(&b, "key");   enc_str(&b, key);
    enc_str(&b, "value"); enc_bytes(&b, (const uint8_t *)value, strlen(value));
    enc_str(&b, "namespace"); enc_str(&b, "c_client");
    if (send_frame(fd, &b)) { free(b.p); return -1; }
    free(b.p);
    m = rpc_recv(fd, rid, &n);
    if (!m) return -1;
    free(m);

    rid = ++g_rid;
    memset(&b, 0, sizeof b);
    enc_dict(&b, 4);
    enc_str(&b, "kind"); enc_str(&b, "kv_get");
    enc_str(&b, "rid");  enc_i64(&b, rid);
    enc_str(&b, "key");  enc_str(&b, key);
    enc_str(&b, "namespace"); enc_str(&b, "c_client");
    if (send_frame(fd, &b)) { free(b.p); return -1; }
    free(b.p);
    m = rpc_recv(fd, rid, &n);
    if (!m) return -1;
    if (dict_find(m, n, "value", &off, &v) != 0 || v.tag != 0x21 ||
        v.len != strlen(value) || memcmp(v.data, value, v.len) != 0) {
        fprintf(stderr, "kv_get: value mismatch\n");
        free(m);
        return -1;
    }
    printf("KV %s=%.*s\n", key, (int)v.len, (const char *)v.data);
    free(m);
    return 0;
}

static int rpc_submit(int fd, const char *client_id, const char *fn_id,
                      const char *fn_blob_file, const char *task_id,
                      const char *return_id, const char *values_blob_file) {
    size_t blob_n, vals_n;
    uint8_t *blob = read_file(fn_blob_file, &blob_n);
    uint8_t *vals = read_file(values_blob_file, &vals_n);
    buf_t b = {0};
    uint32_t n, off;
    val_t v;
    uint8_t *m;
    int64_t rid;
    if (!blob || !vals) {
        fprintf(stderr, "submit: cannot read blob files\n");
        return -1;
    }

    /* export_function: make the pickled callable fetchable by workers */
    rid = ++g_rid;
    enc_dict(&b, 4);
    enc_str(&b, "kind");  enc_str(&b, "export_function");
    enc_str(&b, "rid");   enc_i64(&b, rid);
    enc_str(&b, "fn_id"); enc_str(&b, fn_id);
    enc_str(&b, "blob");  enc_bytes(&b, blob, blob_n);
    if (send_frame(fd, &b)) { free(b.p); return -1; }
    free(b.p);
    m = rpc_recv(fd, rid, &n);
    if (!m) return -1;
    free(m);
    printf("EXPORTED %s\n", fn_id);

    /* submit_task: the no-arg task spec (worker.py::submit's contract) */
    rid = ++g_rid;
    memset(&b, 0, sizeof b);
    enc_dict(&b, 4);
    enc_str(&b, "kind"); enc_str(&b, "submit_task");
    enc_str(&b, "rid");  enc_i64(&b, rid);
    enc_str(&b, "client_id"); enc_str(&b, client_id);
    enc_str(&b, "spec");
    enc_dict(&b, 18);
    enc_str(&b, "task_id");     enc_str(&b, task_id);
    enc_str(&b, "fn_id");       enc_str(&b, fn_id);
    enc_str(&b, "name");        enc_str(&b, "c_client_task");
    enc_str(&b, "owner");       enc_str(&b, client_id);
    enc_str(&b, "return_ids");  enc_list(&b, 1); enc_str(&b, return_id);
    enc_str(&b, "num_returns"); enc_i64(&b, 1);
    enc_str(&b, "deps");        enc_list(&b, 0);
    enc_str(&b, "borrows");     enc_list(&b, 0);
    enc_str(&b, "num_cpus");    enc_i64(&b, 1);
    enc_str(&b, "num_gpus");    enc_i64(&b, 0);
    enc_str(&b, "resources");   enc_dict(&b, 0);
    enc_str(&b, "max_retries"); enc_i64(&b, 0);
    enc_str(&b, "retry_exceptions"); enc_bool(&b, 0);
    enc_str(&b, "scheduling_strategy"); enc_none(&b);
    enc_str(&b, "runtime_env"); enc_none(&b);
    enc_str(&b, "arg_layout");  enc_list(&b, 0);
    enc_str(&b, "kwarg_layout"); enc_dict(&b, 0);
    enc_str(&b, "values_blob"); enc_bytes(&b, vals, vals_n);
    if (send_frame(fd, &b)) { free(b.p); return -1; }
    free(b.p);
    m = rpc_recv(fd, rid, &n);
    if (!m) return -1;
    free(m);
    printf("SUBMITTED %s\n", task_id);
    free(blob);
    free(vals);

    /* get_meta: block until the return object seals */
    rid = ++g_rid;
    memset(&b, 0, sizeof b);
    enc_dict(&b, 4);
    enc_str(&b, "kind"); enc_str(&b, "get_meta");
    enc_str(&b, "rid");  enc_i64(&b, rid);
    enc_str(&b, "object_ids"); enc_list(&b, 1); enc_str(&b, return_id);
    enc_str(&b, "timeout"); enc_i64(&b, 60);
    if (send_frame(fd, &b)) { free(b.p); return -1; }
    free(b.p);
    m = rpc_recv(fd, rid, &n);
    if (!m) return -1;
    /* reply: {"metas": {return_id: {"state": ..., ...}}} */
    if (dict_find(m, n, "metas", &off, &v) != 0 || v.tag != 0x32) {
        fprintf(stderr, "get_meta: no metas dict\n");
        free(m);
        return -1;
    }
    {
        /* descend: metas -> <return_id> -> state */
        uint32_t o = off;
        val_t k, meta;
        if (dec_val(m, n, &o, &k)) { free(m); return -1; }       /* dict tag */
        if (dec_val(m, n, &o, &k) || k.tag != 0x20) { free(m); return -1; }
        if (dict_find(m + o, n - o, "state", &off, &meta) != 0 ||
            meta.tag != 0x20) {
            fprintf(stderr, "get_meta: no state field\n");
            free(m);
            return -1;
        }
        printf("RESULT state=%.*s\n", (int)meta.len, (const char *)meta.data);
        if (!(meta.len == 5 && memcmp(meta.data, "ready", 5) == 0)) {
            free(m);
            return -1;
        }
    }
    free(m);
    return 0;
}

int main(int argc, char **argv) {
    uint8_t *key;
    size_t keylen;
    int fd;
    if (argc < 4) {
        fprintf(stderr, "usage: %s <socket> <authkey_hex> kv|submit ...\n",
                argv[0]);
        return 2;
    }
    if (hex2bin(argv[2], &key, &keylen)) {
        fprintf(stderr, "bad authkey hex\n");
        return 2;
    }
    fd = dial_unix(argv[1]);
    if (fd < 0) {
        fprintf(stderr, "connect %s: %s\n", argv[1], strerror(errno));
        return 1;
    }
    if (auth_handshake(fd, key, keylen)) return 1;
    if (rpc_hello(fd)) return 1;
    if (strcmp(argv[3], "kv") == 0) {
        if (argc != 6) { fprintf(stderr, "kv needs <key> <value>\n"); return 2; }
        if (rpc_kv_roundtrip(fd, argv[4], argv[5])) return 1;
    } else if (strcmp(argv[3], "submit") == 0) {
        if (argc != 10) {
            fprintf(stderr, "submit needs <client_id> <fn_id> <fn_blob> "
                    "<task_id> <return_id> <values_blob>\n");
            return 2;
        }
        if (rpc_submit(fd, argv[4], argv[5], argv[6], argv[7], argv[8],
                       argv[9]))
            return 1;
    } else {
        fprintf(stderr, "unknown mode %s\n", argv[3]);
        return 2;
    }
    close(fd);
    printf("OK\n");
    return 0;
}
