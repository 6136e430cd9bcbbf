// x3d2_tpu_torch native IO runtime (host side of the snapshot and
// checkpoint output; loaded with ctypes by io/native.py, which builds it
// with g++ on first use).
//
// The hot host-side paths around the compute, as the reference keeps them
// native (its ADIOS2 C++ layer, src/io/adios2/io.f90):
//  - strided downcast packing (f64/f32 -> f32) for snapshot striding
//    (reference io_field_utils.f90:290-385 staging path)
//  - base64 VTK payload encoding (snapshot_manager VTK-XML analogue)
//  - background file writer with atomic rename (checkpoint_manager
//    temp-file + mv semantics, checkpoint_manager.f90:296-310); a job
//    that fails to write or rename is counted (async_failed), so a run
//    cannot finish with a truncated file and no error
//
// Build: g++ -O3 -march=native -shared -fPIC -fopenmp -o libx3d2io.so
//        x3d2io.cpp -lpthread

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Strided downcast pack: out[i,j,k] = in[i*sx, j*sy, k*sz] as float32.
// ---------------------------------------------------------------------
void pack_strided_f32_from_f32(const float* in, float* out,
                               int64_t nx, int64_t ny, int64_t nz,
                               int64_t sx, int64_t sy, int64_t sz,
                               int64_t in_sy, int64_t in_sz) {
  // in_sy/in_sz: row strides (elements) of the source array
  const int64_t ox = (nx + sx - 1) / sx;
  const int64_t oy = (ny + sy - 1) / sy;
  const int64_t oz = (nz + sz - 1) / sz;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t i = 0; i < ox; ++i) {
    for (int64_t j = 0; j < oy; ++j) {
      const float* src = in + (i * sx) * in_sy + (j * sy) * in_sz;
      float* dst = out + (i * oy + j) * oz;
      for (int64_t k = 0; k < oz; ++k) dst[k] = src[k * sz];
    }
  }
}

void pack_strided_f32_from_f64(const double* in, float* out,
                               int64_t nx, int64_t ny, int64_t nz,
                               int64_t sx, int64_t sy, int64_t sz,
                               int64_t in_sy, int64_t in_sz) {
  const int64_t ox = (nx + sx - 1) / sx;
  const int64_t oy = (ny + sy - 1) / sy;
  const int64_t oz = (nz + sz - 1) / sz;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t i = 0; i < ox; ++i) {
    for (int64_t j = 0; j < oy; ++j) {
      const double* src = in + (i * sx) * in_sy + (j * sy) * in_sz;
      float* dst = out + (i * oy + j) * oz;
      for (int64_t k = 0; k < oz; ++k) dst[k] = (float)src[k * sz];
    }
  }
}

// ---------------------------------------------------------------------
// base64 encoding of a VTK appended payload (uint32 length header + data)
// Returns encoded length. out must hold 4*ceil((n+4)/3) + 4 bytes.
// ---------------------------------------------------------------------
static const char B64[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

int64_t vtk_base64_encode(const uint8_t* data, int64_t n, char* out) {
  std::vector<uint8_t> buf(n + 4);
  uint32_t len = (uint32_t)n;
  std::memcpy(buf.data(), &len, 4);
  std::memcpy(buf.data() + 4, data, n);
  const int64_t total = n + 4;
  int64_t o = 0;
  int64_t i = 0;
  for (; i + 2 < total; i += 3) {
    uint32_t v = (buf[i] << 16) | (buf[i + 1] << 8) | buf[i + 2];
    out[o++] = B64[(v >> 18) & 63];
    out[o++] = B64[(v >> 12) & 63];
    out[o++] = B64[(v >> 6) & 63];
    out[o++] = B64[v & 63];
  }
  if (i < total) {
    uint32_t v = buf[i] << 16;
    int rem = (int)(total - i);
    if (rem == 2) v |= buf[i + 1] << 8;
    out[o++] = B64[(v >> 18) & 63];
    out[o++] = B64[(v >> 12) & 63];
    out[o++] = rem == 2 ? B64[(v >> 6) & 63] : '=';
    out[o++] = '=';
  }
  return o;
}

// ---------------------------------------------------------------------
// Background writer: queue of (tmp_path, final_path, bytes); a worker
// thread writes and atomically renames. flush() waits for queued work.
// ---------------------------------------------------------------------
namespace {
struct Job {
  std::string tmp, final_, data;
};
// Writer state is intentionally heap-allocated and never destroyed: the
// detached worker thread may be parked in cv.wait() at process exit, and
// destroying a condition_variable with waiters deadlocks glibc's
// __run_exit_handlers. Leaking one small struct at exit is harmless.
struct WriterState {
  std::queue<Job> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<int> pending{0};
  std::atomic<int> failed{0};
  std::thread* worker = nullptr;
};
WriterState* state() {
  static WriterState* s = new WriterState();
  return s;
}

void worker_loop() {
  WriterState* s = state();
  for (;;) {
    Job job;
    {
      std::unique_lock<std::mutex> lk(s->mu);
      s->cv.wait(lk, [s] { return !s->queue.empty(); });
      job = std::move(s->queue.front());
      s->queue.pop();
    }
    bool ok = false;
    FILE* f = std::fopen(job.tmp.c_str(), "wb");
    if (f) {
      ok = std::fwrite(job.data.data(), 1, job.data.size(), f) ==
           job.data.size();
      ok = (std::fclose(f) == 0) && ok;
      ok = ok && std::rename(job.tmp.c_str(), job.final_.c_str()) == 0;
    }
    if (!ok) s->failed.fetch_add(1);
    s->pending.fetch_sub(1);
  }
}
}  // namespace

void async_write(const char* tmp_path, const char* final_path,
                 const uint8_t* data, int64_t n) {
  WriterState* s = state();
  {
    std::lock_guard<std::mutex> lk(s->mu);
    if (!s->worker) {
      s->worker = new std::thread(worker_loop);
      s->worker->detach();
    }
    s->pending.fetch_add(1);
    s->queue.push(Job{tmp_path, final_path,
                      std::string((const char*)data, (size_t)n)});
  }
  s->cv.notify_one();
}

int64_t async_pending() { return state()->pending.load(); }

// jobs that failed to write or rename since the last call (reset to 0)
int64_t async_failed() { return state()->failed.exchange(0); }

void async_flush() {
  while (state()->pending.load() > 0)
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
}

}  // extern "C"
