// Native data-loader runtime: .npy reader + multi-threaded prefetcher.
//
// The reference's host pipeline np.loads every wav2vec feature file serially
// into RAM (text2vec/dataset.py:75-101, vec2wav/dataset.py:181) — the buffer
// load is its startup bottleneck.  This C++ runtime reads .npy files with a
// minimal header parser and overlaps disk I/O across a thread pool, exposed
// to Python through a plain C ABI, loaded with ctypes.
//
// Supported payloads: C-order arrays, dtypes <f4 / <f8 / <i2 / <i4 / <i8,
// ndim <= 4 (the pipeline uses [1, T, 1024] float32).  Output is always
// float32.
//
// Build: data/native_io.py runs g++ -O3 -shared -fPIC -std=c++17 -pthread on it at
// first use, into build/libwtv_io-<hash>.so.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyArray {
  std::unique_ptr<float[]> data;  // handed to the caller by wtv_prefetch_take
  int64_t shape[4] = {0, 0, 0, 0};
  int ndim = 0;
  bool ok = false;
};

bool parse_header(FILE* f, std::string* descr, bool* fortran,
                  std::vector<int64_t>* shape) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
  }
  std::string header(header_len, '\0');
  if (fread(header.data(), 1, header_len, f) != header_len) return false;

  auto find_value = [&](const char* key) -> std::string {
    size_t p = header.find(key);
    if (p == std::string::npos) return "";
    p = header.find(':', p);
    if (p == std::string::npos) return "";
    ++p;
    while (p < header.size() && (header[p] == ' ')) ++p;
    return header.substr(p);
  };

  std::string d = find_value("'descr'");
  if (d.empty() || d[0] != '\'') return false;
  size_t e = d.find('\'', 1);
  *descr = d.substr(1, e - 1);

  std::string fo = find_value("'fortran_order'");
  *fortran = fo.rfind("True", 0) == 0;

  std::string sh = find_value("'shape'");
  size_t open = sh.find('(');
  size_t close = sh.find(')');
  if (open == std::string::npos || close == std::string::npos) return false;
  std::string inner = sh.substr(open + 1, close - open - 1);
  shape->clear();
  const char* p = inner.c_str();
  while (*p) {
    while (*p == ' ' || *p == ',') ++p;
    if (!*p) break;
    shape->push_back(strtoll(p, const_cast<char**>(&p), 10));
  }
  return true;
}

template <typename T>
bool read_cast(FILE* f, int64_t n, std::unique_ptr<float[]>* out) {
  std::vector<T> raw(n);
  if (fread(raw.data(), sizeof(T), n, f) != static_cast<size_t>(n)) return false;
  out->reset(new float[n]);
  for (int64_t i = 0; i < n; ++i) (*out)[i] = static_cast<float>(raw[i]);
  return true;
}

NpyArray load_npy(const std::string& path) {
  NpyArray arr;
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return arr;
  std::string descr;
  bool fortran = false;
  std::vector<int64_t> shape;
  if (!parse_header(f, &descr, &fortran, &shape) || fortran ||
      shape.size() > 4) {
    fclose(f);
    return arr;
  }
  int64_t n = 1;
  for (auto s : shape) n *= s;
  bool ok;
  if (descr == "<f4") {
    arr.data.reset(new float[n]);
    ok = fread(arr.data.get(), 4, n, f) == static_cast<size_t>(n);
  } else if (descr == "<f8") {
    ok = read_cast<double>(f, n, &arr.data);
  } else if (descr == "<i2") {
    ok = read_cast<int16_t>(f, n, &arr.data);
  } else if (descr == "<i4") {
    ok = read_cast<int32_t>(f, n, &arr.data);
  } else if (descr == "<i8") {
    ok = read_cast<int64_t>(f, n, &arr.data);
  } else {
    ok = false;
  }
  fclose(f);
  if (!ok) return arr;
  arr.ndim = static_cast<int>(shape.size());
  for (size_t i = 0; i < shape.size(); ++i) arr.shape[i] = shape[i];
  arr.ok = true;
  return arr;
}

// ---------------------------------------------------------------------------
// Prefetcher: fixed file list, thread pool fills an in-order result window.
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  std::vector<NpyArray> results;
  std::vector<char> done;
  std::atomic<size_t> next_job{0};
  size_t next_emit = 0;
  size_t window = 64;  // max loaded-ahead items held in RAM
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    while (!stop.load()) {
      size_t j = next_job.fetch_add(1);
      if (j >= paths.size()) return;
      {
        // back-pressure: stay within the window of the consumer
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop.load() || j < next_emit + window; });
        if (stop.load()) return;
      }
      NpyArray a = load_npy(paths[j]);
      {
        std::lock_guard<std::mutex> lk(mu);
        results[j] = std::move(a);
        done[j] = 1;
      }
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* wtv_prefetch_create(const char** paths, int n_paths, int n_threads,
                          int window) {
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n_paths);
  p->results.resize(n_paths);
  p->done.assign(n_paths, 0);
  if (window > 0) p->window = window;
  n_threads = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < n_threads; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Pops item ``index`` (must be called with increasing indices) and hands its
// float32 data to the caller, who frees it with wtv_free; fills shape_out[4]
// and *ndim_out.  nullptr on load failure (*ndim_out -1) or a bad index (-3).
float* wtv_prefetch_take(void* handle, int64_t index, int64_t* shape_out,
                         int* ndim_out) {
  auto* p = static_cast<Prefetcher*>(handle);
  *ndim_out = -3;
  if (index < 0 || index >= static_cast<int64_t>(p->paths.size())) return nullptr;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv.wait(lk, [&] { return p->done[index] != 0; });
  NpyArray a = std::move(p->results[index]);
  p->results[index] = NpyArray();
  p->next_emit = static_cast<size_t>(index) + 1;
  lk.unlock();
  p->cv.notify_all();
  *ndim_out = -1;
  if (!a.ok) return nullptr;
  for (int i = 0; i < 4; ++i) shape_out[i] = a.shape[i];
  *ndim_out = a.ndim;
  return a.data.release();
}

void wtv_free(float* data) { delete[] data; }

void wtv_prefetch_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
