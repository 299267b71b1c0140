// Greedy squad formation for the squad (grouped) refinement engine,
// grid-bucketed. Plain C interface for ctypes; built with the host C++
// compiler into build/ at first use (cotr_tpu_torch/native.py).
//
// The same walk as cotr_tpu_torch.inference.grouped._form_squads_numpy, with
// the same result for the same order: go through the permuted candidate
// order; each task that is still free becomes a pilot and is claimed FIRST
// (so the max_load cap can never cut a pilot out of its own squad); every
// other free task whose loc_from AND loc_to lie strictly inside the pilot's
// windows joins, in ascending task id, at most max_load of them. The numpy
// version scans all T tasks for every pilot; here the candidates come from
// a uniform grid over loc_from whose cells are at least the window's
// half-width, so a pilot looks at neighbouring cells only.
//
// lf, lt: (T, 2) float64 task positions; cfx..cty: (T,) patch centre of each
// task as a pilot; active: (T,) uint8; order: permuted candidate ids;
// squad_of: (T,) int64 out (-1 = in no squad); pilots: (T,) int64 out.
// Returns the number of squads.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

int64_t form_squads(const double* lf, const double* lt,
                    const double* cfx, const double* cfy,
                    const double* ctx, const double* cty,
                    const uint8_t* active, int64_t t,
                    double half_f, double half_t,
                    const int64_t* order, int64_t n_order,
                    int64_t max_load,
                    int64_t* squad_of, int64_t* pilots) {
  for (int64_t i = 0; i < t; ++i) squad_of[i] = -1;
  std::vector<uint8_t> free_(t);
  double minx = 1e300, miny = 1e300, maxx = -1e300, maxy = -1e300;
  int64_t n_free = 0;
  for (int64_t i = 0; i < t; ++i) {
    free_[i] = active[i];
    if (!free_[i]) continue;
    minx = std::min(minx, lf[2 * i]);
    maxx = std::max(maxx, lf[2 * i]);
    miny = std::min(miny, lf[2 * i + 1]);
    maxy = std::max(maxy, lf[2 * i + 1]);
    ++n_free;
  }
  if (n_free == 0) return 0;
  // cell size: at least the window half-width (so a window spans <= 2 cell
  // boundaries per axis), never finer than span/2048 per axis (bounds the
  // grid even when half_f ~ 0 — e.g. a degenerate zero patch size — where
  // an unbounded nx*ny would overflow; members then reduce to forced
  // pilots, matching the numpy scan), and large enough to bound the grid
  // at ~4 cells per free task
  const double spanx = maxx - minx, spany = maxy - miny;
  double cell = std::max({half_f, spanx / 2048.0, spany / 2048.0, 1e-9});
  int64_t nx = static_cast<int64_t>(spanx / cell) + 1;
  int64_t ny = static_cast<int64_t>(spany / cell) + 1;
  while (nx * ny > 4 * n_free + 4) {
    cell *= 1.5;
    nx = static_cast<int64_t>(spanx / cell) + 1;
    ny = static_cast<int64_t>(spany / cell) + 1;
  }
  auto cix = [&](double x) {
    int64_t c = static_cast<int64_t>((x - minx) / cell);
    return std::max<int64_t>(0, std::min(c, nx - 1));
  };
  auto ciy = [&](double y) {
    int64_t c = static_cast<int64_t>((y - miny) / cell);
    return std::max<int64_t>(0, std::min(c, ny - 1));
  };
  // CSR buckets; ascending task id within each cell by construction
  std::vector<int64_t> start(nx * ny + 1, 0);
  for (int64_t i = 0; i < t; ++i)
    if (free_[i]) ++start[ciy(lf[2 * i + 1]) * nx + cix(lf[2 * i]) + 1];
  for (size_t b = 1; b < start.size(); ++b) start[b] += start[b - 1];
  std::vector<int64_t> ids(n_free);
  std::vector<int64_t> cursor(start.begin(), start.end() - 1);
  for (int64_t i = 0; i < t; ++i)
    if (free_[i]) ids[cursor[ciy(lf[2 * i + 1]) * nx + cix(lf[2 * i])]++] = i;

  int64_t g = 0;
  std::vector<int64_t> cand;
  cand.reserve(1024);
  for (int64_t oi = 0; oi < n_order; ++oi) {
    const int64_t pid = order[oi];
    if (!free_[pid]) continue;
    // pilot claimed before the candidate sweep (it is skipped below via
    // free_[pid] == 0); squad then holds the pilot + up to max_load others
    free_[pid] = 0;
    squad_of[pid] = g;
    const double pfx = cfx[pid], pfy = cfy[pid];
    const double ptx = ctx[pid], pty = cty[pid];
    cand.clear();
    const int64_t x0 = cix(pfx - half_f), x1 = cix(pfx + half_f);
    const int64_t y0 = ciy(pfy - half_f), y1 = ciy(pfy + half_f);
    for (int64_t cy = y0; cy <= y1; ++cy) {
      for (int64_t cx = x0; cx <= x1; ++cx) {
        const int64_t b = cy * nx + cx;
        for (int64_t k = start[b]; k < start[b + 1]; ++k) {
          const int64_t i = ids[k];
          if (!free_[i]) continue;
          if (!(std::abs(lf[2 * i] - pfx) < half_f)) continue;
          if (!(std::abs(lf[2 * i + 1] - pfy) < half_f)) continue;
          if (!(std::abs(lt[2 * i] - ptx) < half_t)) continue;
          if (!(std::abs(lt[2 * i + 1] - pty) < half_t)) continue;
          cand.push_back(i);
        }
      }
    }
    std::sort(cand.begin(), cand.end());
    const int64_t take =
        std::min<int64_t>(static_cast<int64_t>(cand.size()), max_load);
    for (int64_t k = 0; k < take; ++k) {
      squad_of[cand[k]] = g;
      free_[cand[k]] = 0;
    }
    pilots[g++] = pid;
  }
  return g;
}

}  // extern "C"
