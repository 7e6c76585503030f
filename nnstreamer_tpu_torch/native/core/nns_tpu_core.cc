/**
 * nns_tpu_core — native data-plane primitives for the pipeline runtime.
 *
 * Reference analog: the reference's core runtime is C (GStreamer queues,
 * streaming threads, GstAllocator — SURVEY §2.1/§L0); this library is the
 * PyTorch port's copy of ``nnstreamer_tpu/native/core/nns_tpu_core.cc``,
 * built from this file by ``nnstreamer_tpu_torch/native/runtime.py``:
 *
 *  - opaque-pointer mailbox (bounded MPMC queue, condvar blocking): element
 *    mailboxes block in native code with the GIL released (ctypes foreign
 *    calls drop it), so handoff wakeups are immediate instead of poll-loop
 *    latency, and producers get real backpressure.
 *  - aligned buffer pool (≙ gst_tensor_allocator, tensor_allocator.c:128):
 *    recycled aligned blocks for receive/scratch buffers.
 *
 * Pure C ABI over C++17 internals; loaded via ctypes (no pybind11, no
 * PyTorch headers).  The library never touches Python objects — the Python wrapper
 * owns all refcounting.
 */

#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

/* ------------------------------------------------------------------ *
 * Opaque-pointer mailbox                                             *
 * ------------------------------------------------------------------ */

struct NnsQueue {
  std::mutex m;
  std::condition_variable not_full;
  std::condition_variable not_empty;
  std::condition_variable idle; /* destroy waits for parked waiters */
  std::deque<void *> items;
  size_t capacity;
  int waiters = 0;
  bool closed = false;
};

namespace {
struct WaiterGuard {
  NnsQueue *q; /* lock must be held at construction and destruction */
  explicit WaiterGuard (NnsQueue *q_) : q (q_) { q->waiters++; }
  ~WaiterGuard ()
  {
    if (--q->waiters == 0)
      q->idle.notify_all ();
  }
};
} // namespace

void *nns_oq_create (size_t capacity)
{
  auto *q = new NnsQueue ();
  q->capacity = capacity ? capacity : SIZE_MAX;
  return q;
}

/* 0 = ok, -1 = timeout, -2 = closed.  timeout_s < 0 blocks forever. */
int nns_oq_push (void *h, void *obj, double timeout_s)
{
  auto *q = static_cast<NnsQueue *> (h);
  std::unique_lock<std::mutex> lk (q->m);
  WaiterGuard wg (q);
  auto ready = [q] { return q->closed || q->items.size () < q->capacity; };
  if (timeout_s < 0) {
    q->not_full.wait (lk, ready);
  } else if (!q->not_full.wait_for (
                 lk, std::chrono::duration<double> (timeout_s), ready)) {
    return -1;
  }
  if (q->closed)
    return -2;
  q->items.push_back (obj);
  q->not_empty.notify_one ();
  return 0;
}

/* 0 = ok (obj in *out), -1 = timeout, -2 = closed-and-drained. */
int nns_oq_pop (void *h, double timeout_s, void **out)
{
  auto *q = static_cast<NnsQueue *> (h);
  std::unique_lock<std::mutex> lk (q->m);
  WaiterGuard wg (q);
  auto ready = [q] { return q->closed || !q->items.empty (); };
  if (timeout_s < 0) {
    q->not_empty.wait (lk, ready);
  } else if (!q->not_empty.wait_for (
                 lk, std::chrono::duration<double> (timeout_s), ready)) {
    return -1;
  }
  if (q->items.empty ())
    return -2; /* closed */
  *out = q->items.front ();
  q->items.pop_front ();
  q->not_full.notify_one ();
  return 0;
}

/* Bulk pop: wait (like nns_oq_pop) for the FIRST item, then drain up to
 * max_n without further waiting — one lock/wakeup cycle per micro-batch
 * instead of one per frame.  Returns the item count (>0), -1 = timeout,
 * -2 = closed-and-drained. */
int nns_oq_pop_n (void *h, size_t max_n, double timeout_s, void **out)
{
  auto *q = static_cast<NnsQueue *> (h);
  std::unique_lock<std::mutex> lk (q->m);
  WaiterGuard wg (q);
  auto ready = [q] { return q->closed || !q->items.empty (); };
  if (timeout_s < 0) {
    q->not_empty.wait (lk, ready);
  } else if (!q->not_empty.wait_for (
                 lk, std::chrono::duration<double> (timeout_s), ready)) {
    return -1;
  }
  if (q->items.empty ())
    return -2; /* closed */
  size_t n = 0;
  while (n < max_n && !q->items.empty ()) {
    out[n++] = q->items.front ();
    q->items.pop_front ();
  }
  if (n > 1)
    q->not_full.notify_all (); /* several slots freed at once */
  else
    q->not_full.notify_one ();
  return (int) n;
}

/* Bulk push (block handoff): wait (like nns_oq_push) for space for the
 * FIRST item, then append as many of the rest as fit without further
 * waiting — one lock/wakeup cycle per run of outputs instead of one per
 * frame.  Returns the count consumed (>0), -1 = timeout, -2 = closed. */
int nns_oq_push_n (void *h, void **objs, size_t n_objs, double timeout_s)
{
  auto *q = static_cast<NnsQueue *> (h);
  std::unique_lock<std::mutex> lk (q->m);
  WaiterGuard wg (q);
  auto ready = [q] { return q->closed || q->items.size () < q->capacity; };
  if (timeout_s < 0) {
    q->not_full.wait (lk, ready);
  } else if (!q->not_full.wait_for (
                 lk, std::chrono::duration<double> (timeout_s), ready)) {
    return -1;
  }
  if (q->closed)
    return -2;
  size_t n = 0;
  while (n < n_objs && q->items.size () < q->capacity)
    q->items.push_back (objs[n++]);
  if (n > 1)
    q->not_empty.notify_all (); /* several items landed at once */
  else
    q->not_empty.notify_one ();
  return (int) n;
}

size_t nns_oq_size (void *h)
{
  auto *q = static_cast<NnsQueue *> (h);
  std::lock_guard<std::mutex> lk (q->m);
  return q->items.size ();
}

/* wake all waiters; pending items remain poppable until drained */
void nns_oq_close (void *h)
{
  auto *q = static_cast<NnsQueue *> (h);
  {
    std::lock_guard<std::mutex> lk (q->m);
    q->closed = true;
  }
  q->not_full.notify_all ();
  q->not_empty.notify_all ();
}

/* caller must have drained (or accept leaking the queued pointers' refs —
 * the Python wrapper drains first).  Blocks until every parked waiter has
 * left push/pop so the mutex/condvars are never freed under a waiter. */
void nns_oq_destroy (void *h)
{
  auto *q = static_cast<NnsQueue *> (h);
  {
    std::unique_lock<std::mutex> lk (q->m);
    q->closed = true;
    q->not_full.notify_all ();
    q->not_empty.notify_all ();
    q->idle.wait (lk, [q] { return q->waiters == 0; });
  }
  delete q;
}

/* ------------------------------------------------------------------ *
 * Aligned buffer pool (≙ gst_tensor_allocator)                       *
 * ------------------------------------------------------------------ */

struct NnsPool {
  std::mutex m;
  std::vector<void *> free_blocks;
  size_t block_size;
  size_t alignment;
  size_t outstanding = 0;
};

void *nns_pool_create (size_t block_size, size_t prealloc, size_t alignment)
{
  if (alignment == 0 || (alignment & (alignment - 1)))
    return nullptr; /* must be a power of two */
  auto *p = new NnsPool ();
  p->block_size = block_size;
  p->alignment = alignment < sizeof (void *) ? sizeof (void *) : alignment;
  for (size_t i = 0; i < prealloc; i++) {
    void *b = nullptr;
    if (posix_memalign (&b, p->alignment, block_size) == 0)
      p->free_blocks.push_back (b);
  }
  return p;
}

void *nns_pool_acquire (void *h)
{
  auto *p = static_cast<NnsPool *> (h);
  std::lock_guard<std::mutex> lk (p->m);
  p->outstanding++;
  if (!p->free_blocks.empty ()) {
    void *b = p->free_blocks.back ();
    p->free_blocks.pop_back ();
    return b;
  }
  void *b = nullptr;
  if (posix_memalign (&b, p->alignment, p->block_size) != 0) {
    p->outstanding--;
    return nullptr;
  }
  return b;
}

/* 0 = ok, -1 = double release (ignored: the block stays usable once) */
int nns_pool_release (void *h, void *block)
{
  auto *p = static_cast<NnsPool *> (h);
  std::lock_guard<std::mutex> lk (p->m);
  for (void *b : p->free_blocks)
    if (b == block)
      return -1;
  if (p->outstanding > 0)
    p->outstanding--;
  p->free_blocks.push_back (block);
  return 0;
}

size_t nns_pool_block_size (void *h)
{
  return static_cast<NnsPool *> (h)->block_size;
}

size_t nns_pool_outstanding (void *h)
{
  auto *p = static_cast<NnsPool *> (h);
  std::lock_guard<std::mutex> lk (p->m);
  return p->outstanding;
}

void nns_pool_destroy (void *h)
{
  auto *p = static_cast<NnsPool *> (h);
  for (void *b : p->free_blocks)
    free (b);
  delete p;
}

/* ------------------------------------------------------------------ *
 * mmap sample reader — the datarepo data loader                       *
 *                                                                     *
 * Reference analog: gstdatareposrc.c reads training samples in C      *
 * (read()/seek per sample).  Here: the whole repo file is mapped      *
 * once; a sample read is one memcpy out of the page cache with the    *
 * GIL released (ctypes call), and nns_reader_prefetch() madvises the  *
 * next sample so shuffled epochs stream at page-cache speed.          *
 * ------------------------------------------------------------------ */

struct NnsReader {
  uint8_t *base = nullptr;
  uint64_t file_size = 0;
  uint64_t sample_size = 0;
  int fd = -1;
};

void *nns_reader_open (const char *path, uint64_t sample_size)
{
  if (sample_size == 0)
    return nullptr;
  int fd = ::open (path, O_RDONLY);
  if (fd < 0)
    return nullptr;
  struct stat st;
  if (fstat (fd, &st) != 0 || st.st_size <= 0) {
    ::close (fd);
    return nullptr;
  }
  void *base = mmap (nullptr, (size_t) st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close (fd);
    return nullptr;
  }
  madvise (base, (size_t) st.st_size, MADV_WILLNEED);
  auto *r = new NnsReader ();
  r->base = static_cast<uint8_t *> (base);
  r->file_size = (uint64_t) st.st_size;
  r->sample_size = sample_size;
  r->fd = fd;
  return r;
}

uint64_t nns_reader_total (void *h)
{
  auto *r = static_cast<NnsReader *> (h);
  return r->file_size / r->sample_size;
}

/* copy sample `index` into out (caller allocates sample_size bytes);
 * 0 = ok, -1 = out of range.  Bounds-check BEFORE the multiply: a huge
 * index (e.g. (uint64_t)-1 from a negative Python int) would overflow
 * `index * sample_size` and wrap past the `off + size > file_size` test. */
int nns_reader_read (void *h, uint64_t index, uint8_t *out)
{
  auto *r = static_cast<NnsReader *> (h);
  if (index >= r->file_size / r->sample_size)
    return -1;
  memcpy (out, r->base + index * r->sample_size, r->sample_size);
  return 0;
}

void nns_reader_prefetch (void *h, uint64_t index)
{
  auto *r = static_cast<NnsReader *> (h);
  if (index >= r->file_size / r->sample_size)
    return;
  madvise (r->base + index * r->sample_size, r->sample_size, MADV_WILLNEED);
}

void nns_reader_close (void *h)
{
  auto *r = static_cast<NnsReader *> (h);
  if (r->base)
    munmap (r->base, r->file_size);
  if (r->fd >= 0)
    ::close (r->fd);
  delete r;
}

} /* extern "C" */
