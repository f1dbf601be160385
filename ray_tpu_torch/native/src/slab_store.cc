// Shared-memory slab object store — the native small-object data plane.
//
// Reference parity: src/ray/object_manager/plasma/ (SURVEY.md §2.1) — a
// per-node shared-memory immutable object store with create→seal→get
// semantics.  This is NOT a translation of plasma: plasma is a daemon that
// clients talk to over a unix socket; here the *index itself lives in shared
// memory*, so any attached process resolves an object id to bytes with one
// futex acquire and one memcpy — no daemon round-trip at all.  The control
// plane (GCS, Python) remains the source of truth for refcounts and calls
// rtt_delete when counts hit zero; large objects stay on the file-per-object
// tmpfs path (zero-copy mmap, unlink-safe under live readers).
//
// Layout of the segment (one file under /dev/shm, fixed size):
//   [Header | Slot[max_objects] | heap ............................... ]
// Heap blocks carry boundary tags (header + footer) for O(1) free with
// two-sided coalescing; free blocks form a doubly-linked list threaded
// through their payloads.  Sealed objects form an LRU list threaded through
// the slots (for victim selection if a daemon ever wants to migrate
// slab→file; the allocator itself never silently drops data).
//
// Crash-safety: the mutex is PTHREAD_MUTEX_ROBUST — if a worker dies holding
// it, the next locker gets EOWNERDEAD, marks the state consistent, and
// reaps any unsealed (mid-write) objects the dead process left behind.

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstdio>

namespace {

constexpr uint64_t kMagic = 0x52545055534c4142ULL;  // "RTPUSLAB"
constexpr uint64_t kVersion = 1;
constexpr uint64_t kAlign = 64;  // cache-line; also min split remainder
constexpr int kIdCap = 64;       // max id length incl. NUL

// heap block header/footer ---------------------------------------------------
struct BHdr {
  uint64_t size;   // total block size incl. header+footer
  uint64_t free_;  // 1 = free
};
struct FreeLinks {  // lives in the payload of a free block
  uint64_t next;    // offset of next free block (0 = none)
  uint64_t prev;    // offset of prev free block (0 = none)
};
constexpr uint64_t kBHdr = sizeof(BHdr);
constexpr uint64_t kFoot = sizeof(uint64_t);
constexpr uint64_t kMinBlock = 2 * kAlign;  // fits header+links+footer

struct Slot {
  char id[kIdCap];
  uint64_t hash;
  uint64_t off;   // payload offset (0 = slot empty / tombstone)
  uint64_t size;  // payload bytes
  uint32_t state;  // 0 empty, 1 unsealed, 2 sealed, 3 tombstone
  uint32_t pin;
  int64_t lru_prev, lru_next;  // slot indices, -1 = none
  uint64_t creator_pid;        // for reaping unsealed leftovers of dead writers
};

struct Header {
  uint64_t magic;
  uint64_t version;
  uint64_t total_size;  // whole file
  uint64_t heap_off;
  uint64_t heap_size;
  uint64_t used;  // payload bytes in live (unsealed+sealed) objects
  uint32_t max_objects;
  uint32_t num_objects;  // live slots (unsealed+sealed)
  int64_t lru_head, lru_tail;  // sealed objects, head = oldest
  uint64_t free_head;          // offset of first free block
  uint64_t hits, misses, allocs, fails;
  pthread_mutex_t mu;
};

enum { EMPTY = 0, UNSEALED = 1, SEALED = 2, TOMB = 3 };

inline uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

uint64_t fnv1a(const char* s) {
  uint64_t h = 1469598103934665603ULL;
  for (; *s; ++s) h = (h ^ (uint8_t)*s) * 1099511628211ULL;
  return h;
}

}  // namespace

extern "C" {

struct rtt_store {
  void* base;
  uint64_t len;
};

static inline Header* H(rtt_store* s) { return (Header*)s->base; }
static inline Slot* slots(rtt_store* s) { return (Slot*)((char*)s->base + sizeof(Header)); }
static inline char* heap(rtt_store* s, uint64_t off) { return (char*)s->base + off; }

// -- locking -----------------------------------------------------------------

static void reap_unsealed(rtt_store* s);  // fwd

static int lock(rtt_store* s) {
  int rc = pthread_mutex_lock(&H(s)->mu);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&H(s)->mu);
    reap_unsealed(s);  // a writer died mid-put; its blocks are garbage
    rc = 0;
  }
  return rc;
}
static void unlock(rtt_store* s) { pthread_mutex_unlock(&H(s)->mu); }

// -- free-list heap ----------------------------------------------------------

static void fl_insert(rtt_store* s, uint64_t off) {
  BHdr* b = (BHdr*)heap(s, off);
  b->free_ = 1;
  *(uint64_t*)(heap(s, off) + b->size - kFoot) = b->size;
  FreeLinks* l = (FreeLinks*)(heap(s, off) + kBHdr);
  l->next = H(s)->free_head;
  l->prev = 0;
  if (H(s)->free_head) {
    ((FreeLinks*)(heap(s, H(s)->free_head) + kBHdr))->prev = off;
  }
  H(s)->free_head = off;
}

static void fl_remove(rtt_store* s, uint64_t off) {
  FreeLinks* l = (FreeLinks*)(heap(s, off) + kBHdr);
  if (l->prev)
    ((FreeLinks*)(heap(s, l->prev) + kBHdr))->next = l->next;
  else
    H(s)->free_head = l->next;
  if (l->next) ((FreeLinks*)(heap(s, l->next) + kBHdr))->prev = l->prev;
}

// Returns payload offset or 0 on OOM.  need = payload bytes.
static uint64_t heap_alloc(rtt_store* s, uint64_t need) {
  uint64_t bsz = align_up(kBHdr + need + kFoot, kAlign);
  if (bsz < kMinBlock) bsz = kMinBlock;
  for (uint64_t off = H(s)->free_head; off;) {
    BHdr* b = (BHdr*)heap(s, off);
    uint64_t nxt = ((FreeLinks*)(heap(s, off) + kBHdr))->next;
    if (b->size >= bsz) {
      fl_remove(s, off);
      if (b->size - bsz >= kMinBlock) {  // split
        uint64_t rem_off = off + bsz;
        BHdr* rem = (BHdr*)heap(s, rem_off);
        rem->size = b->size - bsz;
        fl_insert(s, rem_off);
        b->size = bsz;
      }
      b->free_ = 0;
      *(uint64_t*)(heap(s, off) + b->size - kFoot) = b->size;
      return off + kBHdr;
    }
    off = nxt;
  }
  return 0;
}

static void heap_free(rtt_store* s, uint64_t payload_off) {
  uint64_t off = payload_off - kBHdr;
  BHdr* b = (BHdr*)heap(s, off);
  uint64_t heap_lo = H(s)->heap_off;
  uint64_t heap_hi = H(s)->heap_off + H(s)->heap_size;
  // coalesce with next
  uint64_t noff = off + b->size;
  if (noff < heap_hi) {
    BHdr* nb = (BHdr*)heap(s, noff);
    if (nb->free_) {
      fl_remove(s, noff);
      b->size += nb->size;
    }
  }
  // coalesce with prev (its footer sits just below our header)
  if (off > heap_lo) {
    uint64_t psz = *(uint64_t*)(heap(s, off) - kFoot);
    uint64_t poff = off - psz;
    BHdr* pb = (BHdr*)heap(s, poff);
    if (pb->free_) {
      fl_remove(s, poff);
      pb->size += b->size;
      off = poff;
      b = pb;
    }
  }
  fl_insert(s, off);
}

// -- slot table --------------------------------------------------------------

static Slot* find_slot(rtt_store* s, const char* id, uint64_t h) {
  Slot* tab = slots(s);
  uint32_t n = H(s)->max_objects;
  for (uint32_t i = 0; i < n; ++i) {
    Slot* sl = &tab[(h + i) % n];
    if (sl->state == EMPTY) return nullptr;
    if (sl->state != TOMB && sl->hash == h && strncmp(sl->id, id, kIdCap) == 0)
      return sl;
  }
  return nullptr;
}

static Slot* claim_slot(rtt_store* s, const char* id, uint64_t h) {
  Slot* tab = slots(s);
  uint32_t n = H(s)->max_objects;
  Slot* first_tomb = nullptr;
  for (uint32_t i = 0; i < n; ++i) {
    Slot* sl = &tab[(h + i) % n];
    if (sl->state == EMPTY) return first_tomb ? first_tomb : sl;
    if (sl->state == TOMB && !first_tomb) first_tomb = sl;
    if (sl->state != TOMB && sl->hash == h && strncmp(sl->id, id, kIdCap) == 0)
      return nullptr;  // exists
  }
  return first_tomb;  // table full of live+tombs; may still be null
}

static void lru_push(rtt_store* s, Slot* sl) {
  Slot* tab = slots(s);
  int64_t idx = sl - tab;
  sl->lru_prev = H(s)->lru_tail;
  sl->lru_next = -1;
  if (H(s)->lru_tail >= 0) tab[H(s)->lru_tail].lru_next = idx;
  H(s)->lru_tail = idx;
  if (H(s)->lru_head < 0) H(s)->lru_head = idx;
}

static void lru_unlink(rtt_store* s, Slot* sl) {
  Slot* tab = slots(s);
  int64_t idx = sl - tab;
  if (sl->lru_prev >= 0)
    tab[sl->lru_prev].lru_next = sl->lru_next;
  else if (H(s)->lru_head == idx)
    H(s)->lru_head = sl->lru_next;
  if (sl->lru_next >= 0)
    tab[sl->lru_next].lru_prev = sl->lru_prev;
  else if (H(s)->lru_tail == idx)
    H(s)->lru_tail = sl->lru_prev;
  sl->lru_prev = sl->lru_next = -1;
}

static void lru_touch(rtt_store* s, Slot* sl) {
  lru_unlink(s, sl);
  lru_push(s, sl);
}

static void drop_slot(rtt_store* s, Slot* sl) {
  if (sl->state == SEALED) lru_unlink(s, sl);
  heap_free(s, sl->off);
  H(s)->used -= sl->size;
  H(s)->num_objects--;
  sl->state = TOMB;
  sl->off = sl->size = 0;
  sl->pin = 0;
  // Tombstone cleanup: a TOMB whose successor in probe order is EMPTY can
  // itself become EMPTY (no probe chain passes through it), and so can any
  // TOMB run ending here.  Without this, long put/delete churn degrades
  // every miss to a full-table scan under the shm mutex.
  Slot* tab = slots(s);
  uint32_t n = H(s)->max_objects;
  uint32_t idx = (uint32_t)(sl - tab);
  if (tab[(idx + 1) % n].state == EMPTY) {
    for (uint32_t i = 0; i < n && tab[idx].state == TOMB; ++i) {
      tab[idx].state = EMPTY;
      idx = (idx + n - 1) % n;
    }
  }
}

// Free unsealed slots whose creating process is dead.  Used both on
// EOWNERDEAD recovery and by the daemon's worker-death hook.  Checking
// creator liveness (not just state) matters: a *live* writer may hold an
// unsealed slot while memcpy-ing outside the lock; freeing it would let the
// block be reallocated under its in-flight copy.
static int64_t reap_dead_locked(rtt_store* s) {
  Slot* tab = slots(s);
  int64_t n = 0;
  for (uint32_t i = 0; i < H(s)->max_objects; ++i) {
    Slot* sl = &tab[i];
    if (sl->state == UNSEALED && sl->creator_pid &&
        kill((pid_t)sl->creator_pid, 0) != 0 && errno == ESRCH) {
      drop_slot(s, sl);
      n++;
    }
  }
  return n;
}

static void reap_unsealed(rtt_store* s) { reap_dead_locked(s); }

// -- public API --------------------------------------------------------------

rtt_store* rtt_store_open(const char* path, uint64_t capacity,
                            uint32_t max_objects, int create) {
  int fd = -1;
  bool creator = false;
  if (create) {
    fd = open(path, O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd >= 0) creator = true;
  }
  if (fd < 0) {
    fd = open(path, O_RDWR);
    if (fd < 0) return nullptr;
  }
  uint64_t total;
  if (creator) {
    uint64_t table = align_up(sizeof(Header) + (uint64_t)max_objects * sizeof(Slot), kAlign);
    total = table + align_up(capacity, kAlign);
    if (ftruncate(fd, total) != 0) {
      close(fd);
      unlink(path);
      return nullptr;
    }
  } else {
    // attach: wait for the creator to finish initialization (magic is
    // written last); spin briefly on size then on magic.
    struct stat st;
    for (int i = 0; i < 10000; ++i) {
      if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
      if (st.st_size > 0) break;
      usleep(100);
    }
    total = st.st_size;
    if (total < sizeof(Header)) { close(fd); return nullptr; }
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  rtt_store* s = new rtt_store{base, total};
  Header* h = H(s);
  if (creator) {
    uint64_t table = align_up(sizeof(Header) + (uint64_t)max_objects * sizeof(Slot), kAlign);
    h->version = kVersion;
    h->total_size = total;
    h->heap_off = table;
    h->heap_size = total - table;
    h->used = 0;
    h->max_objects = max_objects;
    h->num_objects = 0;
    h->lru_head = h->lru_tail = -1;
    h->free_head = 0;
    h->hits = h->misses = h->allocs = h->fails = 0;
    Slot* tab = slots(s);
    for (uint32_t i = 0; i < max_objects; ++i) {
      tab[i].state = EMPTY;
      tab[i].lru_prev = tab[i].lru_next = -1;
    }
    BHdr* b0 = (BHdr*)heap(s, h->heap_off);
    b0->size = h->heap_size;
    fl_insert(s, h->heap_off);
    pthread_mutexattr_t ma;
    pthread_mutexattr_init(&ma);
    pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&h->mu, &ma);
    pthread_mutexattr_destroy(&ma);
    __sync_synchronize();
    h->magic = kMagic;  // publish
  } else {
    for (int i = 0; i < 10000 && h->magic != kMagic; ++i) usleep(100);
    if (h->magic != kMagic || h->version != kVersion) {
      munmap(base, total);
      delete s;
      return nullptr;
    }
  }
  return s;
}

void rtt_store_close(rtt_store* s) {
  if (!s) return;
  munmap(s->base, s->len);
  delete s;
}

int rtt_store_unlink(const char* path) { return unlink(path); }

// 0 ok | -1 no space | -2 exists | -3 no slot | -6 id too long
int64_t rtt_put(rtt_store* s, const char* id, const void* data, uint64_t size) {
  if (strlen(id) >= kIdCap) return -6;
  uint64_t h = fnv1a(id);
  if (lock(s) != 0) return -7;
  Slot* sl = claim_slot(s, id, h);
  if (!sl) {
    int64_t rc = find_slot(s, id, h) ? -2 : -3;
    H(s)->fails++;
    unlock(s);
    return rc;
  }
  uint64_t off = heap_alloc(s, size ? size : 1);
  if (!off) {
    H(s)->fails++;
    unlock(s);
    return -1;
  }
  // Publish the slot as UNSEALED *before* the memcpy: if this process is
  // killed mid-copy (still inside the critical section), EOWNERDEAD
  // recovery can find and free the block instead of leaking it.
  strncpy(sl->id, id, kIdCap);
  sl->hash = h;
  sl->off = off;
  sl->size = size;
  sl->state = UNSEALED;
  sl->pin = 0;
  sl->creator_pid = (uint64_t)getpid();
  H(s)->used += size;
  H(s)->num_objects++;
  H(s)->allocs++;
  memcpy(heap(s, off), data, size);
  sl->state = SEALED;
  lru_push(s, sl);
  unlock(s);
  return 0;
}

// bytes copied | -1 miss | -5 out buffer too small
int64_t rtt_get(rtt_store* s, const char* id, void* out, uint64_t cap) {
  uint64_t h = fnv1a(id);
  if (lock(s) != 0) return -7;
  Slot* sl = find_slot(s, id, h);
  if (!sl || sl->state != SEALED) {
    H(s)->misses++;
    unlock(s);
    return -1;
  }
  if (sl->size > cap) {
    unlock(s);
    return -5;
  }
  memcpy(out, heap(s, sl->off), sl->size);
  lru_touch(s, sl);
  H(s)->hits++;
  int64_t n = sl->size;
  unlock(s);
  return n;
}

int64_t rtt_size(rtt_store* s, const char* id) {
  if (lock(s) != 0) return -7;
  Slot* sl = find_slot(s, id, fnv1a(id));
  int64_t n = (sl && sl->state == SEALED) ? (int64_t)sl->size : -1;
  unlock(s);
  return n;
}

int rtt_exists(rtt_store* s, const char* id) {
  if (lock(s) != 0) return 0;
  Slot* sl = find_slot(s, id, fnv1a(id));
  int ok = (sl && sl->state == SEALED) ? 1 : 0;
  unlock(s);
  return ok;
}

// 0 ok | -1 miss | -4 pinned
int rtt_delete(rtt_store* s, const char* id) {
  if (lock(s) != 0) return -7;
  Slot* sl = find_slot(s, id, fnv1a(id));
  if (!sl) {
    unlock(s);
    return -1;
  }
  if (sl->pin > 0) {
    unlock(s);
    return -4;
  }
  drop_slot(s, sl);
  unlock(s);
  return 0;
}

// Zero-copy write path: reserve → caller memcpys into base+offset → seal.
int64_t rtt_create(rtt_store* s, const char* id, uint64_t size) {
  if (strlen(id) >= kIdCap) return -6;
  uint64_t h = fnv1a(id);
  if (lock(s) != 0) return -7;
  Slot* sl = claim_slot(s, id, h);
  if (!sl) {
    int64_t rc = find_slot(s, id, h) ? -2 : -3;
    unlock(s);
    return rc;
  }
  uint64_t off = heap_alloc(s, size ? size : 1);
  if (!off) {
    H(s)->fails++;
    unlock(s);
    return -1;
  }
  strncpy(sl->id, id, kIdCap);
  sl->hash = h;
  sl->off = off;
  sl->size = size;
  sl->state = UNSEALED;
  sl->pin = 0;
  sl->creator_pid = (uint64_t)getpid();
  H(s)->used += size;
  H(s)->num_objects++;
  H(s)->allocs++;
  unlock(s);
  return (int64_t)off;
}

int rtt_seal(rtt_store* s, const char* id) {
  if (lock(s) != 0) return -7;
  Slot* sl = find_slot(s, id, fnv1a(id));
  if (!sl || sl->state != UNSEALED) {
    unlock(s);
    return -1;
  }
  sl->state = SEALED;
  lru_push(s, sl);
  unlock(s);
  return 0;
}

// Zero-copy read: returns payload offset and pins the object against delete.
int64_t rtt_lookup_pin(rtt_store* s, const char* id, uint64_t* size) {
  if (lock(s) != 0) return -7;
  Slot* sl = find_slot(s, id, fnv1a(id));
  if (!sl || sl->state != SEALED) {
    H(s)->misses++;
    unlock(s);
    return -1;
  }
  sl->pin++;
  *size = sl->size;
  lru_touch(s, sl);
  H(s)->hits++;
  int64_t off = sl->off;
  unlock(s);
  return off;
}

int rtt_unpin(rtt_store* s, const char* id) {
  if (lock(s) != 0) return -7;
  Slot* sl = find_slot(s, id, fnv1a(id));
  if (sl && sl->pin > 0) sl->pin--;
  unlock(s);
  return 0;
}

void* rtt_base(rtt_store* s) { return s->base; }

// out[0..7] = used, heap_size, num_objects, max_objects, hits, misses, allocs, fails
void rtt_store_stats(rtt_store* s, uint64_t* out) {
  if (lock(s) != 0) { memset(out, 0, 8 * sizeof(uint64_t)); return; }
  Header* h = H(s);
  out[0] = h->used;
  out[1] = h->heap_size;
  out[2] = h->num_objects;
  out[3] = h->max_objects;
  out[4] = h->hits;
  out[5] = h->misses;
  out[6] = h->allocs;
  out[7] = h->fails;
  unlock(s);
}

// LRU victims (oldest first) whose sizes sum to >= need; ids written as
// NUL-separated strings into out (cap bytes).  Returns count.  Pinned and
// unsealed objects are skipped.  The caller decides what to do (migrate to
// file, then rtt_delete) — the store never drops data on its own.
int64_t rtt_lru_victims(rtt_store* s, uint64_t need, char* out, uint64_t cap) {
  if (lock(s) != 0) return -7;
  Slot* tab = slots(s);
  uint64_t acc = 0, w = 0;
  int64_t count = 0;
  for (int64_t i = H(s)->lru_head; i >= 0 && acc < need; i = tab[i].lru_next) {
    Slot* sl = &tab[i];
    if (sl->pin > 0) continue;
    uint64_t idlen = strnlen(sl->id, kIdCap) + 1;
    if (w + idlen > cap) break;
    memcpy(out + w, sl->id, idlen);
    w += idlen;
    acc += sl->size;
    count++;
  }
  unlock(s);
  return count;
}

// Reap unsealed objects whose creating process is gone (died after releasing
// the lock — EOWNERDEAD only covers deaths *inside* the critical section).
// Called by the daemon on worker death and periodically.  Returns count.
int64_t rtt_reap_dead(rtt_store* s) {
  if (lock(s) != 0) return -7;
  int64_t n = reap_dead_locked(s);
  unlock(s);
  return n;
}

}  // extern "C"
