// Host-side single-writer/single-reader ring buffer with the double-VM-map
// trick, plus a threaded file reader that fills it.
//
// grtpu_torch's copy of grtpu/io/native/ringbuf.cc (the code is unchanged).
// Analog of the reference's buffer layer
// (gnuradio-core/src/lib/runtime/gr_vmcircbuf_mmap_shm_open.cc:102-124 —
// one physical region mapped twice back-to-back so wraparound is
// linear-addressable; gr_buffer.cc single-writer/multi-reader protocol).
// Role here: feed the executor's chunk loop from files/sockets at high rate
// without Python-loop copies — the host ingest side of the pipeline, while
// the signal path itself runs on the GPU.
//
// Built with loader.cc into one shared library by the host C++ compiler at
// first use (grtpu_torch/io/native/__init__.py), under build/grtpu_torch/.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct RingBuf {
  uint8_t* base = nullptr;   // double-mapped region (2*size addressable)
  size_t size = 0;           // bytes (page multiple, power-of-two friendly)
  std::atomic<uint64_t> wr{0};  // absolute write offset
  std::atomic<uint64_t> rd{0};  // absolute read offset
  std::atomic<int> eof{0};
  int memfd = -1;
};

}  // namespace

extern "C" {

// Create a ring of at least `min_bytes` (rounded to pages). Returns handle.
RingBuf* grtpu_ring_create(size_t min_bytes) {
  long page = sysconf(_SC_PAGESIZE);
  size_t size = ((min_bytes + page - 1) / page) * page;

  int fd = memfd_create("grtpu_ring", 0);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)size) != 0) { close(fd); return nullptr; }

  // Reserve 2*size of address space, then map the same pages twice —
  // the reference's vmcircbuf trick (mmap_shm_open variant).
  uint8_t* addr = (uint8_t*)mmap(nullptr, 2 * size, PROT_NONE,
                                 MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (addr == MAP_FAILED) { close(fd); return nullptr; }
  if (mmap(addr, size, PROT_READ | PROT_WRITE, MAP_SHARED | MAP_FIXED, fd,
           0) == MAP_FAILED ||
      mmap(addr + size, size, PROT_READ | PROT_WRITE, MAP_SHARED | MAP_FIXED,
           fd, 0) == MAP_FAILED) {
    munmap(addr, 2 * size);
    close(fd);
    return nullptr;
  }
  RingBuf* rb = new RingBuf();
  rb->base = addr;
  rb->size = size;
  rb->memfd = fd;
  return rb;
}

void grtpu_ring_destroy(RingBuf* rb) {
  if (!rb) return;
  munmap(rb->base, 2 * rb->size);
  close(rb->memfd);
  delete rb;
}

size_t grtpu_ring_capacity(RingBuf* rb) { return rb->size; }

size_t grtpu_ring_readable(RingBuf* rb) {
  return (size_t)(rb->wr.load(std::memory_order_acquire) -
                  rb->rd.load(std::memory_order_relaxed));
}

size_t grtpu_ring_writable(RingBuf* rb) {
  return rb->size - grtpu_ring_readable(rb);
}

int grtpu_ring_eof(RingBuf* rb) { return rb->eof.load(); }
void grtpu_ring_set_eof(RingBuf* rb) { rb->eof.store(1); }

// Writer: copy n bytes in (returns bytes accepted, may be < n).
size_t grtpu_ring_write(RingBuf* rb, const uint8_t* src, size_t n) {
  size_t avail = grtpu_ring_writable(rb);
  if (n > avail) n = avail;
  uint64_t w = rb->wr.load(std::memory_order_relaxed);
  memcpy(rb->base + (w % rb->size), src, n);  // linear thanks to double map
  rb->wr.store(w + n, std::memory_order_release);
  return n;
}

// Reader: copy exactly n bytes out if available (returns bytes copied).
size_t grtpu_ring_read(RingBuf* rb, uint8_t* dst, size_t n) {
  size_t avail = grtpu_ring_readable(rb);
  if (n > avail) n = avail;
  uint64_t r = rb->rd.load(std::memory_order_relaxed);
  memcpy(dst, rb->base + (r % rb->size), n);
  rb->rd.store(r + n, std::memory_order_release);
  return n;
}

// Zero-copy read pointer (valid for `grtpu_ring_readable` bytes thanks to
// the double mapping); commit with grtpu_ring_advance.
const uint8_t* grtpu_ring_peek(RingBuf* rb) {
  return rb->base + (rb->rd.load(std::memory_order_relaxed) % rb->size);
}

void grtpu_ring_advance(RingBuf* rb, size_t n) {
  rb->rd.fetch_add(n, std::memory_order_release);
}

// ------------------------------------------------------------------ file
// Background file reader pump: fills the ring from a file descriptor.
struct FilePump {
  RingBuf* rb;
  int fd;
  pthread_t thread;
  std::atomic<int> stop{0};
};

static void* pump_main(void* arg) {
  FilePump* fp = (FilePump*)arg;
  const size_t CHUNK = 1 << 20;
  uint8_t* tmp = new uint8_t[CHUNK];
  while (!fp->stop.load()) {
    size_t room = grtpu_ring_writable(fp->rb);
    if (room == 0) { usleep(200); continue; }
    size_t want = room < CHUNK ? room : CHUNK;
    ssize_t got = read(fp->fd, tmp, want);
    if (got <= 0) { grtpu_ring_set_eof(fp->rb); break; }
    size_t off = 0;
    while (off < (size_t)got && !fp->stop.load()) {
      off += grtpu_ring_write(fp->rb, tmp + off, got - off);
      if (off < (size_t)got) usleep(100);
    }
  }
  delete[] tmp;
  return nullptr;
}

FilePump* grtpu_pump_file(RingBuf* rb, const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  FilePump* fp = new FilePump();
  fp->rb = rb;
  fp->fd = fd;
  if (pthread_create(&fp->thread, nullptr, pump_main, fp) != 0) {
    close(fd);
    delete fp;
    return nullptr;
  }
  return fp;
}

void grtpu_pump_stop(FilePump* fp) {
  if (!fp) return;
  fp->stop.store(1);
  pthread_join(fp->thread, nullptr);
  close(fp->fd);
  delete fp;
}

}  // extern "C"
