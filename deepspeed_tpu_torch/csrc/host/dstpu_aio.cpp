// dstpu_aio — native async file I/O for NVMe tensor swapping.
//
// Capability-equivalent of the reference's AIO library
// (csrc/aio/common/deepspeed_aio_common.cpp:76,96 io_submit/io_getevents,
// deepspeed_aio_thread.cpp worker pool, py_ds_aio.cpp pybind bindings),
// re-implemented for this stack:
//   * io_uring via raw syscalls (no liburing dependency) when the kernel
//     supports it — the modern replacement for the reference's libaio path;
//   * a std::thread pool with pread/pwrite as a portable fallback
//     (the reference's multi-threaded submission path);
//   * O_DIRECT + aligned buffers for real NVMe bandwidth;
//   * a plain C API consumed from Python via ctypes (no pybind11 in image).
//
// Build: g++ -O2 -shared -fPIC -pthread -o libdstpu_aio.so dstpu_aio.cpp

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <linux/io_uring.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <sys/uio.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// io_uring via raw syscalls
// ---------------------------------------------------------------------------

int io_uring_setup(unsigned entries, struct io_uring_params* p) {
  return (int)syscall(__NR_io_uring_setup, entries, p);
}
int io_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                   unsigned flags) {
  return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete, flags,
                      nullptr, 0);
}

struct UringQueue {
  int ring_fd = -1;
  unsigned* sq_head = nullptr;
  unsigned* sq_tail = nullptr;
  unsigned* sq_mask = nullptr;
  unsigned* sq_array = nullptr;
  unsigned* cq_head = nullptr;
  unsigned* cq_tail = nullptr;
  unsigned* cq_mask = nullptr;
  io_uring_sqe* sqes = nullptr;
  io_uring_cqe* cqes = nullptr;
  void* sq_ptr = nullptr;
  void* cq_ptr = nullptr;
  size_t sq_len = 0, cq_len = 0, sqes_len = 0;
  unsigned entries = 0;
  bool ok = false;

  bool init(unsigned depth) {
    io_uring_params p;
    memset(&p, 0, sizeof(p));
    ring_fd = io_uring_setup(depth, &p);
    if (ring_fd < 0) return false;
    entries = p.sq_entries;
    sq_len = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    cq_len = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
    sq_ptr = mmap(nullptr, sq_len, PROT_READ | PROT_WRITE,
                  MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_SQ_RING);
    cq_ptr = mmap(nullptr, cq_len, PROT_READ | PROT_WRITE,
                  MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_CQ_RING);
    sqes_len = p.sq_entries * sizeof(io_uring_sqe);
    sqes = (io_uring_sqe*)mmap(nullptr, sqes_len, PROT_READ | PROT_WRITE,
                               MAP_SHARED | MAP_POPULATE, ring_fd,
                               IORING_OFF_SQES);
    if (sq_ptr == MAP_FAILED || cq_ptr == MAP_FAILED ||
        sqes == (io_uring_sqe*)MAP_FAILED)
      return false;
    auto* sqb = (char*)sq_ptr;
    sq_head = (unsigned*)(sqb + p.sq_off.head);
    sq_tail = (unsigned*)(sqb + p.sq_off.tail);
    sq_mask = (unsigned*)(sqb + p.sq_off.ring_mask);
    sq_array = (unsigned*)(sqb + p.sq_off.array);
    auto* cqb = (char*)cq_ptr;
    cq_head = (unsigned*)(cqb + p.cq_off.head);
    cq_tail = (unsigned*)(cqb + p.cq_off.tail);
    cq_mask = (unsigned*)(cqb + p.cq_off.ring_mask);
    cqes = (io_uring_cqe*)(cqb + p.cq_off.cqes);
    ok = true;
    return true;
  }

  void destroy() {
    if (sq_ptr && sq_ptr != MAP_FAILED) munmap(sq_ptr, sq_len);
    if (cq_ptr && cq_ptr != MAP_FAILED) munmap(cq_ptr, cq_len);
    if (sqes && sqes != (io_uring_sqe*)MAP_FAILED) munmap(sqes, sqes_len);
    if (ring_fd >= 0) close(ring_fd);
    ring_fd = -1;
    ok = false;
  }

  // Submit one rw op; returns false if the SQ is full.
  bool push(int fd, bool write, void* buf, size_t len, off_t offset,
            uint64_t user_data) {
    unsigned tail = __atomic_load_n(sq_tail, __ATOMIC_ACQUIRE);
    unsigned head = __atomic_load_n(sq_head, __ATOMIC_ACQUIRE);
    if (tail - head >= entries) return false;
    unsigned idx = tail & *sq_mask;
    io_uring_sqe* sqe = &sqes[idx];
    memset(sqe, 0, sizeof(*sqe));
    sqe->opcode = write ? IORING_OP_WRITE : IORING_OP_READ;
    sqe->fd = fd;
    sqe->addr = (uint64_t)buf;
    sqe->len = (unsigned)len;
    sqe->off = (uint64_t)offset;
    sqe->user_data = user_data;
    sq_array[idx] = idx;
    __atomic_store_n(sq_tail, tail + 1, __ATOMIC_RELEASE);
    return true;
  }

  int submit_and_wait(unsigned submitted, unsigned wait_for) {
    return io_uring_enter(ring_fd, submitted, wait_for,
                          wait_for ? IORING_ENTER_GETEVENTS : 0);
  }

  // Pop completed events; returns count, accumulates byte results/errors.
  int drain(int64_t* total, int* errors) {
    int n = 0;
    unsigned head = __atomic_load_n(cq_head, __ATOMIC_ACQUIRE);
    unsigned tail = __atomic_load_n(cq_tail, __ATOMIC_ACQUIRE);
    while (head != tail) {
      io_uring_cqe* cqe = &cqes[head & *cq_mask];
      if (cqe->res < 0)
        (*errors)++;
      else
        *total += cqe->res;
      head++;
      n++;
    }
    __atomic_store_n(cq_head, head, __ATOMIC_RELEASE);
    return n;
  }
};

// ---------------------------------------------------------------------------
// Thread-pool fallback engine (reference: deepspeed_aio_thread.cpp)
// ---------------------------------------------------------------------------

struct Pool {
  std::vector<std::thread> workers;
  std::deque<std::function<void()>> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<int> inflight{0};
  std::condition_variable done_cv;
  std::mutex done_mu;
  bool stop = false;

  void start(int n) {
    for (int i = 0; i < n; i++)
      workers.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu);
            cv.wait(lk, [this] { return stop || !queue.empty(); });
            if (stop && queue.empty()) return;
            job = std::move(queue.front());
            queue.pop_front();
          }
          job();
          if (inflight.fetch_sub(1) == 1) {
            std::lock_guard<std::mutex> lk(done_mu);
            done_cv.notify_all();
          }
        }
      });
  }

  void post(std::function<void()> f) {
    inflight.fetch_add(1);
    {
      std::lock_guard<std::mutex> lk(mu);
      queue.push_back(std::move(f));
    }
    cv.notify_one();
  }

  void wait_all() {
    std::unique_lock<std::mutex> lk(done_mu);
    done_cv.wait(lk, [this] { return inflight.load() == 0; });
  }

  void shutdown() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& w : workers) w.join();
    workers.clear();
  }
};

// ---------------------------------------------------------------------------
// Handle
// ---------------------------------------------------------------------------

struct Handle {
  unsigned block_size;
  unsigned queue_depth;
  int n_threads;
  bool use_uring;
  UringQueue ring;
  Pool pool;
  std::atomic<int64_t> sync_err{0};
  // One ring (and one pool wait_all) per handle: concurrent submissions from
  // different threads would interleave inflight accounting and deadlock.
  // Callers wanting read/write overlap open two handles.
  std::mutex op_mu;
};

int do_chunked_uring(Handle* h, int fd, bool write, char* buf, int64_t len,
                     int64_t file_offset) {
  int64_t done_bytes = 0;
  int errors = 0;
  int64_t submitted_off = 0;
  unsigned inflight = 0;
  while (done_bytes < len) {
    // fill the queue
    while (submitted_off < len && inflight < h->queue_depth) {
      size_t chunk = (size_t)std::min<int64_t>(h->block_size, len - submitted_off);
      if (!h->ring.push(fd, write, buf + submitted_off, chunk,
                        file_offset + submitted_off, 0))
        break;
      submitted_off += chunk;
      inflight++;
    }
    if (h->ring.submit_and_wait(inflight, 1) < 0) return -1;
    int64_t got = 0;
    int n = h->ring.drain(&got, &errors);
    inflight -= n;
    done_bytes += got;
    if (errors) return -1;
    if (n == 0 && submitted_off >= len && inflight == 0) break;
  }
  return done_bytes == len ? 0 : -1;
}

int do_chunked_pool(Handle* h, int fd, bool write, char* buf, int64_t len,
                    int64_t file_offset) {
  std::atomic<int> errors{0};
  int64_t nchunks = (len + h->block_size - 1) / h->block_size;
  for (int64_t c = 0; c < nchunks; c++) {
    int64_t off = c * (int64_t)h->block_size;
    size_t chunk = (size_t)std::min<int64_t>(h->block_size, len - off);
    h->pool.post([=, &errors] {
      ssize_t r = write ? pwrite(fd, buf + off, chunk, file_offset + off)
                        : pread(fd, buf + off, chunk, file_offset + off);
      if (r != (ssize_t)chunk) errors.fetch_add(1);
    });
  }
  h->pool.wait_all();
  return errors.load() ? -1 : 0;
}

}  // namespace

extern "C" {

// Returns an opaque handle (reference: aio_handle ctor py_ds_aio.cpp:12).
void* dstpu_aio_open(unsigned block_size, unsigned queue_depth, int n_threads) {
  auto* h = new Handle;
  h->block_size = block_size ? block_size : (1u << 20);
  h->queue_depth = queue_depth ? queue_depth : 32;
  h->n_threads = n_threads > 0 ? n_threads : 4;
  h->use_uring = h->ring.init(h->queue_depth);
  if (!h->use_uring) h->pool.start(h->n_threads);
  return h;
}

int dstpu_aio_uses_uring(void* hp) { return ((Handle*)hp)->use_uring ? 1 : 0; }

void dstpu_aio_close(void* hp) {
  auto* h = (Handle*)hp;
  if (h->use_uring)
    h->ring.destroy();
  else
    h->pool.shutdown();
  delete h;
}

// Synchronous (but internally parallel) file read/write of a whole buffer.
// direct=1 opens O_DIRECT (buffer+size must be 4k aligned).
int dstpu_aio_pread(void* hp, const char* path, void* buf, int64_t len,
                    int64_t file_offset, int direct) {
  auto* h = (Handle*)hp;
  std::lock_guard<std::mutex> op_lk(h->op_mu);
  int flags = O_RDONLY | (direct ? O_DIRECT : 0);
  int fd = open(path, flags);
  if (fd < 0 && direct) fd = open(path, O_RDONLY);  // fs may refuse O_DIRECT
  if (fd < 0) return -1;
  int rc = h->use_uring
               ? do_chunked_uring(h, fd, false, (char*)buf, len, file_offset)
               : do_chunked_pool(h, fd, false, (char*)buf, len, file_offset);
  close(fd);
  return rc;
}

int dstpu_aio_pwrite(void* hp, const char* path, const void* buf, int64_t len,
                     int64_t file_offset, int direct) {
  auto* h = (Handle*)hp;
  std::lock_guard<std::mutex> op_lk(h->op_mu);
  int flags = O_WRONLY | O_CREAT | (direct ? O_DIRECT : 0);
  int fd = open(path, flags, 0644);
  if (fd < 0 && direct) fd = open(path, O_WRONLY | O_CREAT, 0644);
  if (fd < 0) return -1;
  int rc = h->use_uring
               ? do_chunked_uring(h, fd, true, (char*)buf, len, file_offset)
               : do_chunked_pool(h, fd, true, (char*)buf, len, file_offset);
  close(fd);
  return rc;
}

// Aligned buffer management (reference: deepspeed_pin_tensor.cpp).
void* dstpu_aio_alloc(int64_t size) {
  void* p = nullptr;
  if (posix_memalign(&p, 4096, (size_t)size) != 0) return nullptr;
  return p;
}

void dstpu_aio_free(void* p) { free(p); }

}  // extern "C"
