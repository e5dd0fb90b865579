// Batched Euler-split edge coloring — the host half of Benes route
// construction (lux_tpu_torch/ops/route.py).  A copy of the reference
// package's lux_tpu/native/lux_route.cc, built on its own by
// lux_tpu_torch/native/__init__.py (g++, at first use).  Colors B
// independent deg-regular bipartite multigraphs with deg colors each
// (every color class a perfect matching), by recursive Euler partitions
// that halve the regularity.  This is the construction-time bottleneck
// of routed permutations at benchmark scale; the per-iteration device
// replay is unaffected.
//
// Error contract: return 0 on success, negative errno-style codes
// otherwise; never abort.
//
// Design note: same recursion as route.py::_color_regular (a stack of
// (edge-range, deg, color-base) over an in-place stably-partitioned id
// array), with the per-split Euler walk of _split_regular.  Outputs are
// valid colorings but NOT guaranteed bit-identical to the Python walk —
// ops/route.py's oracle contract is replay equality (x[perm]), which
// any valid coloring satisfies.

#include <atomic>
#include <cstdint>
#include <climits>
#include <thread>
#include <vector>

namespace {

constexpr int kErrBadArg = -22;   // EINVAL
constexpr int kErrRange = -34;    // ERANGE: node id out of [0, nside)

struct Scratch {
  // int32 throughout (n < 2^31 by contract): the Euler walk is random-
  // access latency-bound, so narrow types halve the hot working set.
  // ``ids`` lives here for the serial walk; the threaded walk passes a
  // per-batch ids buffer explicitly (frames of one batch share it,
  // touching disjoint [lo, hi) ranges).
  std::vector<int32_t> ids, ids_tmp;      // edge ids, stable-partition tmp
  std::vector<int32_t> us, vs;            // sub-graph endpoints
  std::vector<int32_t> l_off, r_off;      // CSR offsets per side
  std::vector<int32_t> l_edges, r_edges;  // CSR edge lists
  std::vector<int32_t> l_ptr, r_ptr;      // walk skip pointers
  std::vector<uint8_t> used, half;
};

// Split the deg-regular multigraph on edges ids[lo, hi) into two
// (deg/2)-regular halves via one Euler partition; stable-partition the
// id range so the first half precedes the second.  Returns the split
// point.  ``ids`` is the (caller-owned) id permutation the range lives
// in; only [lo, hi) is read or written, so disjoint ranges are safe to
// split concurrently.
int64_t euler_split(const int64_t* u, const int64_t* v, int32_t* ids,
                    Scratch& s, int64_t lo, int64_t hi, int64_t nside) {
  const int64_t m = hi - lo;
  s.us.resize(m);
  s.vs.resize(m);
  for (int64_t k = 0; k < m; ++k) {
    s.us[k] = static_cast<int32_t>(u[ids[lo + k]]);
    s.vs[k] = static_cast<int32_t>(v[ids[lo + k]]);
  }
  // counting-sort CSR incidence per side
  s.l_off.assign(nside + 1, 0);
  s.r_off.assign(nside + 1, 0);
  for (int64_t k = 0; k < m; ++k) {
    ++s.l_off[s.us[k] + 1];
    ++s.r_off[s.vs[k] + 1];
  }
  for (int64_t i = 0; i < nside; ++i) {
    s.l_off[i + 1] += s.l_off[i];
    s.r_off[i + 1] += s.r_off[i];
  }
  s.l_edges.resize(m);
  s.r_edges.resize(m);
  s.l_ptr.assign(s.l_off.begin(), s.l_off.end() - 1);
  s.r_ptr.assign(s.r_off.begin(), s.r_off.end() - 1);
  for (int64_t k = 0; k < m; ++k) {
    s.l_edges[s.l_ptr[s.us[k]]++] = k;
    s.r_edges[s.r_ptr[s.vs[k]]++] = k;
  }
  s.l_ptr.assign(s.l_off.begin(), s.l_off.end() - 1);
  s.r_ptr.assign(s.r_off.begin(), s.r_off.end() - 1);
  s.used.assign(m, 0);
  s.half.assign(m, 0);

  auto next_l = [&](int32_t node) -> int32_t {
    int32_t p = s.l_ptr[node];
    const int32_t stop = s.l_off[node + 1];
    while (p < stop && s.used[s.l_edges[p]]) ++p;
    s.l_ptr[node] = p;
    return p < stop ? s.l_edges[p] : -1;
  };
  auto next_r = [&](int32_t node) -> int32_t {
    int32_t p = s.r_ptr[node];
    const int32_t stop = s.r_off[node + 1];
    while (p < stop && s.used[s.r_edges[p]]) ++p;
    s.r_ptr[node] = p;
    return p < stop ? s.r_edges[p] : -1;
  };

  // walk Euler circuits, assigning alternate halves along each circuit
  for (int64_t e0 = 0; e0 < m; ++e0) {
    if (s.used[e0]) continue;
    int32_t e = static_cast<int32_t>(e0);
    uint8_t take = 1;
    for (;;) {
      s.used[e] = 1;
      s.half[e] = take;
      take ^= 1;
      int32_t nxt = next_r(s.vs[e]);
      if (nxt < 0) break;
      e = nxt;
      s.used[e] = 1;
      s.half[e] = take;
      take ^= 1;
      nxt = next_l(s.us[e]);
      if (nxt < 0) break;
      e = nxt;
    }
  }

  // stable partition ids[lo, hi): half==1 first (Python keeps the
  // mask-True subset first)
  s.ids_tmp.resize(m);
  int64_t w = 0;
  for (int64_t k = 0; k < m; ++k)
    if (s.half[k]) s.ids_tmp[w++] = ids[lo + k];
  const int64_t split = w;
  for (int64_t k = 0; k < m; ++k)
    if (!s.half[k]) s.ids_tmp[w++] = ids[lo + k];
  for (int64_t k = 0; k < m; ++k) ids[lo + k] = s.ids_tmp[k];
  return lo + split;
}

int color_one(const int64_t* u, const int64_t* v, int64_t n, int32_t deg,
              int64_t nside, int32_t* colors, Scratch& s) {
  for (int64_t k = 0; k < n; ++k)
    if (u[k] < 0 || u[k] >= nside || v[k] < 0 || v[k] >= nside)
      return kErrRange;
  s.ids.resize(n);
  for (int64_t k = 0; k < n; ++k) s.ids[k] = static_cast<int32_t>(k);
  // explicit recursion stack of (lo, hi, deg, base)
  struct Frame { int64_t lo, hi; int32_t deg, base; };
  std::vector<Frame> stack;
  stack.push_back({0, n, deg, 0});
  while (!stack.empty()) {
    Frame f = stack.back();
    stack.pop_back();
    if (f.deg == 1) {
      for (int64_t k = f.lo; k < f.hi; ++k) colors[s.ids[k]] = f.base;
      continue;
    }
    const int64_t mid = euler_split(u, v, s.ids.data(), s, f.lo, f.hi,
                                    nside);
    stack.push_back({f.lo, mid, f.deg / 2, f.base});
    stack.push_back({mid, f.hi, f.deg / 2,
                     static_cast<int32_t>(f.base + f.deg / 2)});
  }
  return 0;
}

int color_batched_impl(const int64_t* u, const int64_t* v, int64_t batches,
                       int64_t n, int32_t deg, int64_t nside,
                       int32_t* colors, int32_t n_threads) {
  // nside * deg == n is the regularity contract; rejecting it here also
  // bounds the O(nside) scratch allocations (a huge nside would throw
  // bad_alloc across the extern-C boundary and abort the process)
  if (batches < 0 || n < 0 || n > INT32_MAX || deg <= 0 ||
      (deg & (deg - 1)) != 0 || nside <= 0 || nside * deg != n)
    return kErrBadArg;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 256) n_threads = 256;  // sanity clamp for a bad caller
  if (n_threads <= 1) {
    Scratch s;
    for (int64_t b = 0; b < batches; ++b) {
      const int rc = color_one(u + b * n, v + b * n, n, deg, nside,
                               colors + b * n, s);
      if (rc != 0) return rc;
    }
    return 0;
  }
  // Threaded walk: LEVEL-SYNCHRONOUS frame parallelism.  A "frame" is
  // one (batch, [lo, hi), deg, base) node of the Euler recursion tree;
  // frames of one level touch DISJOINT id/color ranges (siblings are
  // the two halves of their parent's range, batches are disjoint by
  // construction), so any schedule writes the same bytes as the serial
  // stack walk — the split of a range depends only on the range's ids,
  // which the parent fixed before its children exist.  Parallelizing
  // frames (not just batches) matters because the planners' top
  // recursion level is ONE batch (B=1) of the full n: batch-only
  // threading would leave the single biggest coloring serial.
  std::atomic<int> err(0);
  struct Frame { int64_t batch, lo, hi; int32_t deg, base; };
  // per-batch id permutations, shared across threads within a level
  std::vector<std::vector<int32_t>> ids(batches);
  std::vector<Frame> frames;
  frames.reserve(batches);
  for (int64_t b = 0; b < batches; ++b)
    frames.push_back({b, 0, n, deg, 0});

  // per-worker Scratch persists ACROSS levels: the level-0 frame sizes
  // it at O(n) and later levels reuse the capacity instead of paying
  // hundreds of MB of fresh page faults per level
  std::vector<Scratch> scratch(n_threads);
  auto level_parallel = [&](auto&& body, int64_t count) {
    std::atomic<int64_t> next(0);
    auto work = [&](int32_t t) {
      Scratch& s = scratch[t];
      for (;;) {
        const int64_t i = next.fetch_add(1, std::memory_order_relaxed);
        if (i >= count || err.load(std::memory_order_relaxed) != 0) break;
        body(i, s);
      }
    };
    std::vector<std::thread> pool;
    pool.reserve(n_threads - 1);
    for (int32_t t = 1; t < n_threads; ++t) pool.emplace_back(work, t);
    work(0);
    for (auto& th : pool) th.join();
  };

  // level -1: validate + init per-batch ids (O(n) scans, parallel)
  level_parallel([&](int64_t b, Scratch&) {
    const int64_t* ub = u + b * n;
    const int64_t* vb = v + b * n;
    for (int64_t k = 0; k < n; ++k)
      if (ub[k] < 0 || ub[k] >= nside || vb[k] < 0 || vb[k] >= nside) {
        int expected = 0;
        err.compare_exchange_strong(expected, kErrRange);
        return;
      }
    ids[b].resize(n);
    for (int64_t k = 0; k < n; ++k)
      ids[b][k] = static_cast<int32_t>(k);
  }, batches);
  if (err.load() != 0) return err.load();

  std::vector<Frame> children;
  while (!frames.empty()) {
    children.assign(2 * frames.size(), Frame{});
    level_parallel([&](int64_t i, Scratch& s) {
      const Frame& f = frames[i];
      int32_t* bids = ids[f.batch].data();
      int32_t* bcol = colors + f.batch * n;
      if (f.deg == 1) {
        for (int64_t k = f.lo; k < f.hi; ++k) bcol[bids[k]] = f.base;
        children[2 * i] = {f.batch, 0, 0, 0, 0};      // leaf: no children
        children[2 * i + 1] = {f.batch, 0, 0, 0, 0};
        return;
      }
      const int64_t mid = euler_split(u + f.batch * n, v + f.batch * n,
                                      bids, s, f.lo, f.hi, nside);
      children[2 * i] = {f.batch, f.lo, mid, f.deg / 2, f.base};
      children[2 * i + 1] = {f.batch, mid, f.hi, f.deg / 2,
                             static_cast<int32_t>(f.base + f.deg / 2)};
    }, static_cast<int64_t>(frames.size()));
    if (err.load() != 0) return err.load();
    frames.clear();
    for (const Frame& c : children)
      if (c.deg > 0) frames.push_back(c);
  }
  return 0;
}

}  // namespace

extern "C" int lux_route_color_batched(const int64_t* u, const int64_t* v,
                                       int64_t batches, int64_t n,
                                       int32_t deg, int64_t nside,
                                       int32_t* colors) {
  return color_batched_impl(u, v, batches, n, deg, nside, colors, 1);
}

// Threaded entry: identical output bytes for any n_threads (per-B
// sub-problems are independent; see color_batched_impl).
extern "C" int lux_route_color_batched_mt(const int64_t* u, const int64_t* v,
                                          int64_t batches, int64_t n,
                                          int32_t deg, int64_t nside,
                                          int32_t* colors,
                                          int32_t n_threads) {
  return color_batched_impl(u, v, batches, n, deg, nside, colors, n_threads);
}
