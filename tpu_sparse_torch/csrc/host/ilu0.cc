// Host-side ILU(0) factor of a DIA matrix and its level schedule
// (C++, plain C interface).
//
// The factor is the arithmetic of tpu_sparse/precond/poly.py::ilu0_factor,
// row by row: for each row i, IKJ elimination against the factored rows
// i - k for k = w .. 1 over the stored negative offsets -k, with the
// multiplier m = row[-k] / pivot (a zero pivot counts as 1), an update
// row[o] -= m * U(i - k)[o + k] only where o + k is a stored positive
// offset and o != -k, and m stored as L's entry. Rows i - k < 0 act as
// zero rows. The last w factored rows live in a ring (the JAX scan's
// carry), so the working set is w rows of ndiag values. The values are
// A's dtype: one template, instantiated for float, double,
// std::complex<float> and std::complex<double>. The complex pivot rule is
// the real one (a pivot equal to 0 + 0i counts as 1); a complex quotient
// is std::complex's (gcc's __divdc3, scaled to avoid overflow), so it may
// differ from XLA's in the last bits, not more.
//
// The same pass computes the level schedule of the two triangular
// substitutions from the factors' nonzeros: a row's forward level is one
// more than the largest forward level of the rows its nonzero L entries
// read (0 when it reads none), its backward level the same on U in
// reverse. Stored zeros (the grid wrap-around entries of a stencil) do
// not chain rows, which is what keeps the wavefronts of a stencil short.
//
// Layout: data and out are DIA arrays (ndiag, n), entry (d, i) = A[i, i +
// offsets[d]]; out holds L's multipliers on the negative offsets and U on
// the others, as the JAX scan's factored band. Built with the host C++
// compiler at first use and reached through ctypes
// (tpu_sparse_torch/precond/_native.py).

#include <algorithm>
#include <complex>
#include <cstdint>
#include <cstdlib>
#include <utility>
#include <vector>

namespace {

template <typename T>
void ilu0(int64_t n, int64_t nd, const int64_t* offsets, const T* data,
             T* out, int32_t* lev_f, int32_t* lev_b, int64_t* n_levels) {
  int64_t w = 0;
  for (int64_t d = 0; d < nd; ++d)
    w = std::max<int64_t>(w, std::llabs(offsets[d]));
  // index of each offset in [-w, w] (-1: not stored; the last one wins
  // for a repeated offset, as in the JAX band)
  std::vector<int64_t> at(2 * w + 1, -1);
  for (int64_t d = 0; d < nd; ++d) at[offsets[d] + w] = d;
  const int64_t d0 = at[w];  // stored: the caller checks

  // The elimination steps in order k = w .. 1: the slot of L's entry and
  // the (target, source) slot pairs of its updates, in offsets order.
  struct Step {
    int64_t k, dl;
    std::vector<std::pair<int64_t, int64_t>> upd;
  };
  std::vector<Step> steps;
  for (int64_t k = w; k >= 1; --k) {
    if (at[w - k] < 0) continue;
    Step s{k, at[w - k], {}};
    for (int64_t d = 0; d < nd; ++d) {
      const int64_t src = offsets[d] + k;
      if (src <= 0 || src > w || at[w + src] < 0 || offsets[d] == -k)
        continue;
      s.upd.emplace_back(d, at[w + src]);
    }
    steps.push_back(std::move(s));
  }

  std::vector<T> ring((w + 1) * nd, T(0));
  const std::vector<T> zero(nd, T(0));
  std::vector<T> row(nd);
  std::vector<int64_t> neg, pos;
  for (int64_t d = 0; d < nd; ++d) {
    if (offsets[d] < 0) neg.push_back(d);
    if (offsets[d] > 0) pos.push_back(d);
  }

  int32_t top_f = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t d = 0; d < nd; ++d) row[d] = data[d * n + i];
    for (const Step& s : steps) {
      const T* piv =
          i - s.k >= 0 ? &ring[((i - s.k) % (w + 1)) * nd] : zero.data();
      const T p = piv[d0];
      const T safe = p != T(0) ? p : T(1);
      const T m = row[s.dl] / safe;
      for (const auto& tu : s.upd) row[tu.first] += -m * piv[tu.second];
      row[s.dl] = m;
    }
    std::copy(row.begin(), row.end(), &ring[(i % (w + 1)) * nd]);
    for (int64_t d = 0; d < nd; ++d) out[d * n + i] = row[d];
    int32_t lv = 0;
    for (int64_t d : neg) {
      const int64_t j = i + offsets[d];
      if (j >= 0 && row[d] != T(0)) lv = std::max(lv, lev_f[j] + 1);
    }
    lev_f[i] = lv;
    top_f = std::max(top_f, lv);
  }

  int32_t top_b = 0;
  for (int64_t i = n - 1; i >= 0; --i) {
    int32_t lv = 0;
    for (int64_t d : pos) {
      const int64_t j = i + offsets[d];
      if (j < n && out[d * n + i] != T(0)) lv = std::max(lv, lev_b[j] + 1);
    }
    lev_b[i] = lv;
    top_b = std::max(top_b, lv);
  }
  n_levels[0] = n > 0 ? top_f + 1 : 0;
  n_levels[1] = n > 0 ? top_b + 1 : 0;
}

}  // namespace

extern "C" {

// ILU(0) of a float64 / float32 DIA matrix and its forward / backward
// levels. The main diagonal (offset 0) must be stored.
void ts_ilu0_f64(int64_t n, int64_t nd, const int64_t* offsets,
                 const double* data, double* out, int32_t* lev_f,
                 int32_t* lev_b, int64_t* n_levels) {
  ilu0<double>(n, nd, offsets, data, out, lev_f, lev_b, n_levels);
}

void ts_ilu0_f32(int64_t n, int64_t nd, const int64_t* offsets,
                 const float* data, float* out, int32_t* lev_f,
                 int32_t* lev_b, int64_t* n_levels) {
  ilu0<float>(n, nd, offsets, data, out, lev_f, lev_b, n_levels);
}

// The same for complex128 / complex64 values, interleaved (re, im) pairs
// of double / float (the layout of std::complex and of numpy's complex
// arrays).
void ts_ilu0_c128(int64_t n, int64_t nd, const int64_t* offsets,
                  const double* data, double* out, int32_t* lev_f,
                  int32_t* lev_b, int64_t* n_levels) {
  using C = std::complex<double>;
  ilu0<C>(n, nd, offsets, reinterpret_cast<const C*>(data),
          reinterpret_cast<C*>(out), lev_f, lev_b, n_levels);
}

void ts_ilu0_c64(int64_t n, int64_t nd, const int64_t* offsets,
                 const float* data, float* out, int32_t* lev_f,
                 int32_t* lev_b, int64_t* n_levels) {
  using C = std::complex<float>;
  ilu0<C>(n, nd, offsets, reinterpret_cast<const C*>(data),
          reinterpret_cast<C*>(out), lev_f, lev_b, n_levels);
}

}  // extern "C"
