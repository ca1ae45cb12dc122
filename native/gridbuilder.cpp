// Native scene-construction runtime.
//
// The framework's compute path is JAX/XLA; host-side scene construction
// (the part the reference does with worker threads + atomics:
// reference terrain/terrain.zig:113-127 spawning N threads over X-slabs,
// brick/Grid.zig:141-148 atomic brick allocation,
// brick/MaterialAllocator.zig:34-43 atomic material-window bump allocator)
// is re-implemented here as a C++ shared library driven through ctypes
// (see zig_vulkan_jax/io/native_builder.py).
//
// Data layout matches zig_vulkan_jax.core.grid exactly:
//   statuses   u32[ceil(cells/32)]  1 bit per cell
//   indices    u32[cells]           cell -> brick slot
//   occupancy  u32[brick_alloc*2]   64 voxel bits per brick (little-endian)
//   starts     u32[brick_alloc]     material window start, 0xFFFFFFFF unset
//   materials  u8[brick_alloc*64]
//
// Build: g++ -O3 -march=native -shared -fPIC -o libzvtgrid.so gridbuilder.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kBrickDim = 4;
constexpr uint32_t kBrickBits = kBrickDim * kBrickDim * kBrickDim;  // 64
constexpr uint32_t kBrickWords = 2;
constexpr uint32_t kUnset = 0xFFFFFFFFu;

struct Grid {
  uint32_t dim_x, dim_y, dim_z;
  uint64_t cells;
  uint64_t brick_alloc;

  std::vector<std::atomic<uint32_t>> statuses;   // bit per cell
  std::vector<std::atomic<uint32_t>> indices;    // cell -> brick (guarded by status)
  std::vector<std::atomic<uint32_t>> occupancy;  // bits
  std::vector<std::atomic<uint32_t>> starts;     // material window starts
  std::vector<std::atomic<uint8_t>> materials;   // material bytes

  std::atomic<uint32_t> active_bricks{0};
  std::atomic<uint32_t> material_cursor{0};
  // per-cell allocation latch: 0 = free, 1 = allocating, 2 = done,
  // 3 = allocation failed (terminal: waiters error out instead of spinning)
  std::vector<std::atomic<uint8_t>> cell_latch;

  Grid(uint32_t dx, uint32_t dy, uint32_t dz, uint64_t alloc)
      : dim_x(dx), dim_y(dy), dim_z(dz),
        cells(uint64_t(dx) * dy * dz), brick_alloc(alloc),
        statuses((cells + 31) / 32), indices(cells),
        occupancy(alloc * kBrickWords), starts(alloc),
        materials(alloc * kBrickBits), cell_latch(cells) {
    for (auto& s : statuses) s.store(0, std::memory_order_relaxed);
    for (auto& s : indices) s.store(0, std::memory_order_relaxed);
    for (auto& s : occupancy) s.store(0, std::memory_order_relaxed);
    for (auto& s : starts) s.store(kUnset, std::memory_order_relaxed);
    for (auto& s : materials) s.store(0, std::memory_order_relaxed);
    for (auto& s : cell_latch) s.store(0, std::memory_order_relaxed);
  }

  // one voxel insert; thread-safe (the Grid.zig:129-194 algorithm with the
  // reference's fetchAdd allocation, plus a per-cell latch closing the
  // check-then-allocate race the reference tolerates)
  bool insert(int64_t x, int64_t y, int64_t z, uint8_t mat) {
    const int64_t vx = int64_t(dim_x) * kBrickDim;
    const int64_t vy = int64_t(dim_y) * kBrickDim;
    const int64_t vz = int64_t(dim_z) * kBrickDim;
    if (x < 0 || x >= vx || y < 0 || y >= vy || z < 0 || z >= vz) return false;
    const int64_t fy = (vy - 1) - y;  // Y flip (Grid.zig:135)

    const uint64_t cell =
        uint64_t(x / kBrickDim) +
        uint64_t(dim_x) * (uint64_t(z / kBrickDim) +
                           uint64_t(dim_z) * uint64_t(fy / kBrickDim));
    const uint32_t nth =
        uint32_t(x % kBrickDim) +
        kBrickDim * (uint32_t(z % kBrickDim) + kBrickDim * uint32_t(fy % kBrickDim));

    // brick slot: allocate once per cell
    uint32_t brick;
    const uint32_t word = uint32_t(cell / 32), bit = uint32_t(cell % 32);
    if (statuses[word].load(std::memory_order_acquire) & (1u << bit)) {
      brick = indices[cell].load(std::memory_order_acquire);
    } else {
      uint8_t expected = 0;
      if (cell_latch[cell].compare_exchange_strong(expected, 1,
                                                   std::memory_order_acq_rel)) {
        brick = active_bricks.fetch_add(1, std::memory_order_relaxed);
        if (brick >= brick_alloc) {
          // exhausted: publish the terminal latch state so concurrent
          // waiters on this cell stop spinning and error out too
          cell_latch[cell].store(3, std::memory_order_release);
          return false;
        }
        indices[cell].store(brick, std::memory_order_release);
        const uint32_t start =
            material_cursor.fetch_add(kBrickBits, std::memory_order_relaxed);
        starts[brick].store(start, std::memory_order_release);
        statuses[word].fetch_or(1u << bit, std::memory_order_release);
        cell_latch[cell].store(2, std::memory_order_release);
      } else {
        uint8_t state;
        while ((state = cell_latch[cell].load(std::memory_order_acquire)) == 1) {
        }
        if (state != 2) return false;  // allocation failed on another thread
        brick = indices[cell].load(std::memory_order_acquire);
      }
    }

    const uint32_t start = starts[brick].load(std::memory_order_acquire) & 0x7FFFFFFFu;
    materials[uint64_t(start) + nth].store(mat, std::memory_order_relaxed);
    occupancy[uint64_t(brick) * kBrickWords + nth / 32].fetch_or(
        1u << (nth % 32), std::memory_order_relaxed);
    return true;
  }
};

// ---- RTNW perlin (terrain/perlin.zig:63-147 semantics) ----------------------
struct Perlin {
  const double* rand_float;  // [256]
  const int32_t* px;
  const int32_t* py;
  const int32_t* pz;

  double smooth(double x, double y, double z) const {
    const int64_t i = int64_t(std::floor(x));
    const int64_t j = int64_t(std::floor(y));
    const int64_t k = int64_t(std::floor(z));
    double u = x - std::floor(x), v = y - std::floor(y), w = z - std::floor(z);
    u = u * u * (3.0 - 2.0 * u);
    v = v * v * (3.0 - 2.0 * v);
    w = w * w * (3.0 - 2.0 * w);
    double accum = 0.0;
    for (int di = 0; di < 2; ++di)
      for (int dj = 0; dj < 2; ++dj)
        for (int dk = 0; dk < 2; ++dk) {
          const double c =
              rand_float[px[(i + di) & 255] ^ py[(j + dj) & 255] ^ pz[(k + dk) & 255]];
          accum += (di * u + (1 - di) * (1.0 - u)) * (dj * v + (1 - dj) * (1.0 - v)) *
                   (dk * w + (1 - dk) * (1.0 - w)) * c;
        }
    return accum;
  }
};

// lowbias32 (matches io/terrain.py _hash_u32)
inline uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

inline double roll(uint32_t seed, uint32_t x, uint32_t y, uint32_t z) {
  const uint32_t key = x + y * 73856093u + z * 19349663u + seed;
  return double(hash_u32(key)) / 4294967296.0;
}

}  // namespace

extern "C" {

void* zvt_grid_create(uint32_t dx, uint32_t dy, uint32_t dz, uint64_t brick_alloc) {
  return new Grid(dx, dy, dz, brick_alloc);
}

void zvt_grid_destroy(void* g) { delete static_cast<Grid*>(g); }

// returns number of successfully inserted voxels
uint64_t zvt_insert_batch(void* gp, uint64_t n, const int64_t* xs, const int64_t* ys,
                          const int64_t* zs, const uint8_t* mats, int threads) {
  Grid& g = *static_cast<Grid*>(gp);
  if (threads < 1) threads = 1;
  std::atomic<uint64_t> ok{0};
  std::vector<std::thread> pool;
  const uint64_t per = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&, t] {
      const uint64_t lo = uint64_t(t) * per;
      const uint64_t hi = std::min(n, lo + per);
      uint64_t local = 0;
      for (uint64_t i = lo; i < hi; ++i)
        local += g.insert(xs[i], ys[i], zs[i], mats[i]) ? 1 : 0;
      ok.fetch_add(local, std::memory_order_relaxed);
    });
  }
  for (auto& th : pool) th.join();
  return ok.load();
}

// perlin terrain (terrain/terrain.zig:43-128 semantics, X-slab threads)
void zvt_generate_terrain(void* gp, const double* rand_float, const int32_t* perm_x,
                          const int32_t* perm_y, const int32_t* perm_z,
                          uint32_t seed, double scale, int64_t ocean_level,
                          int threads) {
  Grid& g = *static_cast<Grid*>(gp);
  const int64_t vx = int64_t(g.dim_x) * kBrickDim;
  const int64_t vy = int64_t(g.dim_y) * kBrickDim;
  const int64_t vz = int64_t(g.dim_z) * kBrickDim;
  const double terrain_max_height = vy * 0.5;
  const Perlin perlin{rand_float, perm_x, perm_y, perm_z};
  if (threads < 1) threads = 1;

  std::vector<std::thread> pool;
  const int64_t slab = (vx + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&, t] {
      const int64_t x0 = t * slab;
      const int64_t x1 = std::min(vx, x0 + slab);
      for (int64_t x = x0; x < x1; ++x) {
        for (int64_t z = 0; z < vz; ++z) {
          const double pxc = double(x) * (scale / double(vx));
          const double pzc = double(z) * (scale / double(vz));
          const double noise = std::min(perlin.smooth(pxc, 0.0, pzc), 1.0);
          const int64_t height = int64_t(noise * terrain_max_height);
          int64_t y = height / 2;
          for (; y < height; ++y) {
            const double hl = 1.0 + (3.4 - 1.0) * (double(y) / terrain_max_height);
            const double band_roll = roll(seed, uint32_t(x), uint32_t(y), uint32_t(z));
            int band = int(std::floor(hl + band_roll * 0.5));
            if (band < 0) band = 0;
            if (band > 3) band = 3;
            uint8_t mat = 0;
            if (band > 0) {
              static const int base[4] = {0, 1, 3, 5};
              const double pick =
                  roll(seed ^ 0x5BD1E995u, uint32_t(x), uint32_t(y), uint32_t(z));
              mat = uint8_t(base[band] + int(pick + 0.5));
            }
            g.insert(x, y, z, mat);
          }
          for (; y < ocean_level; ++y) g.insert(x, y, z, 0);  // water
        }
      }
    });
  }
  for (auto& th : pool) th.join();
}

// copy-out accessors (numpy allocates; we fill)
void zvt_export(void* gp, uint32_t* statuses, uint32_t* indices, uint32_t* occupancy,
                uint32_t* starts, uint8_t* materials, uint32_t* counters) {
  Grid& g = *static_cast<Grid*>(gp);
  for (size_t i = 0; i < g.statuses.size(); ++i) statuses[i] = g.statuses[i].load();
  for (size_t i = 0; i < g.indices.size(); ++i) indices[i] = g.indices[i].load();
  for (size_t i = 0; i < g.occupancy.size(); ++i) occupancy[i] = g.occupancy[i].load();
  for (size_t i = 0; i < g.starts.size(); ++i) starts[i] = g.starts[i].load();
  for (size_t i = 0; i < g.materials.size(); ++i) materials[i] = g.materials[i].load();
  // after an exhaustion failure the fetch_add may have pushed the counter
  // past capacity; clamp so the exported count stays a valid brick count
  counters[0] = std::min<uint32_t>(g.active_bricks.load(), uint32_t(g.brick_alloc));
  counters[1] = g.material_cursor.load();
}

}  // extern "C"
