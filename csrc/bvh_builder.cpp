// Native multicore BVH builder (binned SAH).
//
// The reference's performance-critical host component is its parallel BVH
// build (src/bvh.rs:142, BVHf::build_par via the external
// `bvh` crate). This is our native equivalent: a C++ binned-SAH top-down
// builder with a work-stealing task pool over subtree ranges, producing the
// same flattened node arrays as the NumPy builder in
// gpu_raytracer/models/bvh.py (root = node 0, child sentinel -1,
// triangles re-ordered into contiguous leaf ranges).
//
// C ABI, loaded via ctypes (gpu_raytracer/models/bvh_native.py).

#include <atomic>
#include <algorithm>
#include <cfloat>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <chrono>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kBins = 16;
constexpr int32_t kLeaf = -1;

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float area(const Vec3& mn, const Vec3& mx) {
  float dx = std::max(mx.x - mn.x, 0.f);
  float dy = std::max(mx.y - mn.y, 0.f);
  float dz = std::max(mx.z - mn.z, 0.f);
  return 2.f * (dx * dy + dy * dz + dz * dx);
}

struct Task {
  int32_t node;
  int64_t lo, hi;
  int32_t depth;
};

struct Builder {
  const Vec3* tmin;
  const Vec3* tmax;
  const Vec3* cent;
  int64_t* order;
  int32_t leaf_size;
  int64_t cap;

  float* node_min;
  float* node_max;
  int32_t* left;
  int32_t* right;
  int32_t* tri_start;
  int32_t* tri_count;

  std::atomic<int64_t> n_nodes{1};
  std::atomic<int32_t> max_depth{1};
  std::atomic<int64_t> open_tasks{0};
  std::atomic<bool> overflow{false};

  std::mutex mu;
  std::condition_variable cv;
  std::deque<Task> queue;

  void push(Task t) {
    {
      std::lock_guard<std::mutex> g(mu);
      queue.push_back(t);
    }
    cv.notify_one();
  }

  bool pop(Task* t) {
    std::unique_lock<std::mutex> g(mu);
    for (;;) {
      if (!queue.empty()) {
        *t = queue.front();
        queue.pop_front();
        return true;
      }
      if (open_tasks.load() == 0) return false;
      cv.wait_for(g, std::chrono::milliseconds(1));
    }
  }

  void process(const Task& task) {
    int64_t lo = task.lo, hi = task.hi, count = hi - lo;
    int32_t node = task.node;
    // depth tracking
    int32_t d = task.depth, cur = max_depth.load();
    while (d > cur && !max_depth.compare_exchange_weak(cur, d)) {
    }

    Vec3 bmin = {FLT_MAX, FLT_MAX, FLT_MAX};
    Vec3 bmax = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    Vec3 cmin = bmin, cmax = bmax;
    for (int64_t i = lo; i < hi; ++i) {
      int64_t id = order[i];
      bmin = vmin(bmin, tmin[id]);
      bmax = vmax(bmax, tmax[id]);
      cmin = vmin(cmin, cent[id]);
      cmax = vmax(cmax, cent[id]);
    }
    std::memcpy(node_min + 3 * node, &bmin, 12);
    std::memcpy(node_max + 3 * node, &bmax, 12);

    if (count <= leaf_size) {
      left[node] = kLeaf;
      right[node] = kLeaf;
      tri_start[node] = static_cast<int32_t>(lo);
      tri_count[node] = static_cast<int32_t>(count);
      return;
    }

    // widest centroid axis
    float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int64_t mid = lo + count / 2;
    if (ext[axis] > 0.f) {
      const float cmin_a = axis == 0 ? cmin.x : (axis == 1 ? cmin.y : cmin.z);
      const float scale = kBins * (1.f - 1e-6f) / ext[axis];
      int64_t bin_cnt[kBins] = {0};
      Vec3 bin_min[kBins], bin_max[kBins];
      for (int b = 0; b < kBins; ++b) {
        bin_min[b] = {FLT_MAX, FLT_MAX, FLT_MAX};
        bin_max[b] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      }
      auto bin_of = [&](int64_t id) {
        const Vec3& c = cent[id];
        float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
        int b = static_cast<int>((v - cmin_a) * scale);
        return std::min(std::max(b, 0), kBins - 1);
      };
      for (int64_t i = lo; i < hi; ++i) {
        int64_t id = order[i];
        int b = bin_of(id);
        bin_cnt[b]++;
        bin_min[b] = vmin(bin_min[b], tmin[id]);
        bin_max[b] = vmax(bin_max[b], tmax[id]);
      }
      // prefix/suffix SAH sweeps
      float lcost[kBins], rcost[kBins];
      {
        Vec3 mn = {FLT_MAX, FLT_MAX, FLT_MAX}, mx = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        int64_t c = 0;
        for (int b = 0; b < kBins; ++b) {
          mn = vmin(mn, bin_min[b]);
          mx = vmax(mx, bin_max[b]);
          c += bin_cnt[b];
          lcost[b] = c ? area(mn, mx) * c : 0.f;
        }
        mn = {FLT_MAX, FLT_MAX, FLT_MAX};
        mx = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        c = 0;
        for (int b = kBins - 1; b >= 0; --b) {
          mn = vmin(mn, bin_min[b]);
          mx = vmax(mx, bin_max[b]);
          c += bin_cnt[b];
          rcost[b] = c ? area(mn, mx) * c : 0.f;
        }
      }
      int best = -1;
      float best_cost = FLT_MAX;
      int64_t lsum = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        lsum += bin_cnt[b];
        if (lsum == 0 || lsum == count) continue;
        float cost = lcost[b] + rcost[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best = b;
        }
      }
      if (best >= 0) {
        int64_t* first = order + lo;
        int64_t* last = order + hi;
        int64_t* it = std::partition(first, last, [&](int64_t id) {
          return bin_of(id) <= best;
        });
        mid = lo + (it - first);
        if (mid == lo || mid == hi) mid = lo + count / 2;
      }
    }

    int64_t base = n_nodes.fetch_add(2);
    if (base + 2 > cap) {
      overflow.store(true);
      left[node] = kLeaf;
      right[node] = kLeaf;
      tri_start[node] = static_cast<int32_t>(lo);
      tri_count[node] = static_cast<int32_t>(count);
      return;
    }
    int32_t l = static_cast<int32_t>(base), r = static_cast<int32_t>(base + 1);
    left[node] = l;
    right[node] = r;
    open_tasks.fetch_add(2);
    // keep one child local for cache locality when small, else enqueue both
    push({l, lo, mid, task.depth + 1});
    push({r, mid, hi, task.depth + 1});
  }

  void worker() {
    Task t;
    while (pop(&t)) {
      process(t);
      open_tasks.fetch_sub(1);
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" int64_t bvh_build(
    const float* vertices, int64_t V, const uint32_t* indices, int64_t T,
    int32_t leaf_size, float* node_min, float* node_max, int32_t* left,
    int32_t* right, int32_t* tri_start, int32_t* tri_count, int64_t* tri_order,
    int32_t* max_depth) {
  if (T <= 0 || leaf_size <= 0) return -1;
  (void)V;

  std::vector<Vec3> tmin(T), tmax(T), cent(T);
  for (int64_t t = 0; t < T; ++t) {
    const uint32_t* tri = indices + 3 * t;
    Vec3 a = {vertices[3 * tri[0]], vertices[3 * tri[0] + 1],
              vertices[3 * tri[0] + 2]};
    Vec3 b = {vertices[3 * tri[1]], vertices[3 * tri[1] + 1],
              vertices[3 * tri[1] + 2]};
    Vec3 c = {vertices[3 * tri[2]], vertices[3 * tri[2] + 1],
              vertices[3 * tri[2] + 2]};
    tmin[t] = vmin(a, vmin(b, c));
    tmax[t] = vmax(a, vmax(b, c));
    cent[t] = {(tmin[t].x + tmax[t].x) * 0.5f, (tmin[t].y + tmax[t].y) * 0.5f,
               (tmin[t].z + tmax[t].z) * 0.5f};
    tri_order[t] = t;
  }

  Builder b;
  b.tmin = tmin.data();
  b.tmax = tmax.data();
  b.cent = cent.data();
  b.order = tri_order;
  b.leaf_size = leaf_size;
  b.cap = std::max<int64_t>(2 * T + 2, 16);
  b.node_min = node_min;
  b.node_max = node_max;
  b.left = left;
  b.right = right;
  b.tri_start = tri_start;
  b.tri_count = tri_count;

  b.open_tasks.store(1);
  b.push({0, 0, T, 1});

  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = static_cast<int>(std::min<unsigned>(std::max(hw, 1u), 32u));
  if (T < 4096) n_threads = 1;
  std::vector<std::thread> pool;
  for (int i = 1; i < n_threads; ++i) pool.emplace_back([&b] { b.worker(); });
  b.worker();
  for (auto& th : pool) th.join();

  if (b.overflow.load()) return -2;
  *max_depth = b.max_depth.load();
  return b.n_nodes.load();
}
