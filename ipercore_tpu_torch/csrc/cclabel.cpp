// Connected-component bounding boxes over binary masks (host code).
//
// The port's copy of `native/cclabel.cpp`, built by
// `ipercore_tpu_torch/utils/cuda_build.py` with the host C++ compiler and
// bound by `ipercore_tpu_torch/utils/native.py`. Detection
// (`ipercore_tpu_torch/tools/detection.py`) takes per-frame component boxes
// from coarse foreground grids: a two-pass union-find labeling
// (8-connectivity) emitting [x0, y0, x1, y1, area] per component.
#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct UF {
  std::vector<int32_t> parent;
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[b] = a;
  }
  int32_t add() {
    int32_t id = static_cast<int32_t>(parent.size());
    parent.push_back(id);
    return id;
  }
};

}  // namespace

extern "C" {

// mask: (h, w) uint8 (nonzero = foreground), row-major.
// out: (max_comps, 5) int32 [x0, y0, x1, y1, area] (exclusive x1/y1).
// Returns the number of components written (sorted by area, descending),
// or -1 on error.
int cc_boxes(const uint8_t* mask, int64_t h, int64_t w, int32_t* out,
             int64_t max_comps) {
  if (!mask || !out || h <= 0 || w <= 0 || max_comps <= 0) return -1;
  std::vector<int32_t> labels(static_cast<size_t>(h) * w, -1);
  UF uf;
  // pass 1: provisional labels, merging with W, NW, N, NE neighbours
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      if (!mask[y * w + x]) continue;
      int32_t best = -1;
      const int64_t nx[4] = {x - 1, x - 1, x, x + 1};
      const int64_t ny[4] = {y, y - 1, y - 1, y - 1};
      for (int i = 0; i < 4; ++i) {
        if (nx[i] < 0 || nx[i] >= w || ny[i] < 0) continue;
        int32_t l = labels[ny[i] * w + nx[i]];
        if (l < 0) continue;
        if (best < 0) {
          best = l;
        } else {
          uf.unite(best, l);
        }
      }
      if (best < 0) best = uf.add();
      labels[y * w + x] = best;
    }
  }
  // pass 2: accumulate per-root boxes
  const int32_t n = static_cast<int32_t>(uf.parent.size());
  if (n == 0) return 0;
  std::vector<int32_t> x0(n, INT32_MAX), y0(n, INT32_MAX), x1(n, -1), y1(n, -1);
  std::vector<int64_t> area(n, 0);
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      int32_t l = labels[y * w + x];
      if (l < 0) continue;
      int32_t r = uf.find(l);
      if (x < x0[r]) x0[r] = static_cast<int32_t>(x);
      if (y < y0[r]) y0[r] = static_cast<int32_t>(y);
      if (x >= x1[r]) x1[r] = static_cast<int32_t>(x) + 1;
      if (y >= y1[r]) y1[r] = static_cast<int32_t>(y) + 1;
      ++area[r];
    }
  }
  std::vector<int32_t> roots;
  for (int32_t i = 0; i < n; ++i)
    if (area[i] > 0) roots.push_back(i);
  // sort by area descending (components beyond max_comps are the smallest)
  std::sort(roots.begin(), roots.end(),
            [&](int32_t a, int32_t b) { return area[a] > area[b]; });
  int32_t written = 0;
  for (int32_t r : roots) {
    if (written >= max_comps) break;
    int32_t* row = out + static_cast<int64_t>(written) * 5;
    row[0] = x0[r];
    row[1] = y0[r];
    row[2] = x1[r];
    row[3] = y1[r];
    row[4] = static_cast<int32_t>(area[r] > INT32_MAX ? INT32_MAX : area[r]);
    ++written;
  }
  return written;
}

}  // extern "C"
