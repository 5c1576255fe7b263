// Host-side AMG setup kernels of tpu_sparse_torch (C++, plain C interface).
//
// The graph phase of the aggregation AMG setup: strength-of-connection
// greedy aggregation, the Galerkin product RAP for a piecewise-constant
// prolongator, and the row L1 norms of the L1-Jacobi smoother. The solve
// phase runs on the card; this phase has data-dependent shapes and runs on
// the host, once per matrix. Built with the host C++ compiler at first use
// and reached through ctypes (tpu_sparse_torch/precond/_native.py).
//
// The same algorithms as tpu_sparse/native/amg_setup.cc, copied so that the
// port depends on nothing of the JAX package. The DIA->CSR and CWELL-pack
// entry points are left out: the port builds those on the card.
//
// Conventions: CSR with int32 indptr/indices, float64 values, symmetric
// pattern (SPD-style operators, the AMG target class). Aggregate ids are
// int64.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Greedy size-targeted aggregation with symmetric strength-of-connection
// |a_ij| >= theta * sqrt(|a_ii a_jj|). Mirrors the AGGREGATION/SIZE_4
// selector behavior the reference configures (torch_amgx.py:50-73).
// Deterministic: nodes visited in index order.
// Returns the number of aggregates; agg_out[i] in [0, n_agg).
int64_t ts_aggregate(int64_t n, const int32_t* indptr,
                     const int32_t* indices, const double* data,
                     double theta, int32_t target_size, int64_t* agg_out) {
  std::vector<double> diag(n, 0.0);
  for (int64_t i = 0; i < n; ++i)
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k)
      if (indices[k] == i) diag[i] += data[k];

  std::vector<int64_t> agg(n, -1);
  int64_t next = 0;

  // Phase 1: seed an aggregate at each unassigned node, absorbing up to
  // target_size-1 unassigned strong neighbors.
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    agg[i] = next;
    int32_t taken = 1;
    for (int32_t k = indptr[i]; k < indptr[i + 1] && taken < target_size;
         ++k) {
      int32_t j = indices[k];
      if (j == i || agg[j] != -1) continue;
      double thr = theta * std::sqrt(std::fabs(diag[i] * diag[j]));
      if (std::fabs(data[k]) >= thr) {
        agg[j] = next;
        ++taken;
      }
    }
    ++next;
  }

  // Phase 2: merge singleton aggregates into a neighboring aggregate.
  std::vector<int64_t> sizes(next, 0);
  for (int64_t i = 0; i < n; ++i) ++sizes[agg[i]];
  for (int64_t i = 0; i < n; ++i) {
    if (sizes[agg[i]] != 1) continue;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int32_t j = indices[k];
      if (j == i) continue;
      int64_t t = agg[j];
      if (t != agg[i] && sizes[t] < 2 * target_size) {
        --sizes[agg[i]];
        agg[i] = t;
        ++sizes[t];
        break;
      }
    }
  }

  // Compact ids in first-use order (== ascending original id order).
  std::vector<int64_t> remap(next, -1);
  int64_t na = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (remap[agg[i]] == -1) remap[agg[i]] = na++;
    agg_out[i] = remap[agg[i]];
  }
  return na;
}

// Galerkin RAP for a piecewise-constant (unsmoothed-aggregation)
// prolongator: Ac[agg[i], agg[j]] = sum A[i, j]. Parallel by contiguous
// coarse-row ranges (std::thread), balanced by entry counts; each range is
// gathered, sorted and coalesced independently, so the output is
// bit-identical for a fixed thread count (and identical in structure to
// the sequential global sort). Caller provides output buffers of capacity
// >= nnz(A). Returns nnz(Ac), or -1 if the capacity is insufficient.
int64_t ts_rap_pc(int64_t n, int64_t nc, const int32_t* indptr,
                  const int32_t* indices, const double* data,
                  const int64_t* agg, int32_t* indptr_c, int32_t* indices_c,
                  double* data_c, int64_t cap) {
  int64_t nnz = indptr[n];

  // Group fine rows by coarse row (counting sort; deterministic order).
  std::vector<int64_t> grp_cnt(nc + 1, 0);       // entries per coarse row
  std::vector<int64_t> row_cnt(nc + 1, 0);       // fine rows per coarse row
  for (int64_t i = 0; i < n; ++i) {
    row_cnt[agg[i] + 1]++;
    grp_cnt[agg[i] + 1] += indptr[i + 1] - indptr[i];
  }
  for (int64_t r = 0; r < nc; ++r) {
    row_cnt[r + 1] += row_cnt[r];
    grp_cnt[r + 1] += grp_cnt[r];
  }
  std::vector<int64_t> rows_by_agg(n);
  {
    std::vector<int64_t> cur(row_cnt.begin(), row_cnt.end() - 1);
    for (int64_t i = 0; i < n; ++i) rows_by_agg[cur[agg[i]]++] = i;
  }

  int nt = (int)std::min<int64_t>(
      std::max(1u, std::thread::hardware_concurrency()),
      std::max<int64_t>(nnz / (1 << 18), 1));
  // Contiguous coarse-row ranges with ~equal entry counts.
  std::vector<int64_t> range(nt + 1, nc);
  range[0] = 0;
  for (int t = 1; t < nt; ++t) {
    int64_t target = grp_cnt[nc] * t / nt;
    range[t] = std::lower_bound(grp_cnt.begin(), grp_cnt.begin() + nc + 1,
                                target) - grp_cnt.begin();
    if (range[t] > nc) range[t] = nc;
  }
  for (int t = 1; t <= nt; ++t) range[t] = std::max(range[t], range[t - 1]);

  std::vector<std::vector<int32_t>> out_idx(nt);
  std::vector<std::vector<double>> out_val(nt);
  std::vector<std::vector<int32_t>> out_rcnt(nt);  // nnz per coarse row

  auto work = [&](int t) {
    std::vector<std::pair<int32_t, double>> buf;
    out_rcnt[t].assign(range[t + 1] - range[t], 0);
    for (int64_t r = range[t]; r < range[t + 1]; ++r) {
      buf.clear();
      for (int64_t q = row_cnt[r]; q < row_cnt[r + 1]; ++q) {
        int64_t i = rows_by_agg[q];
        for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k)
          buf.emplace_back((int32_t)agg[indices[k]], data[k]);
      }
      std::sort(buf.begin(), buf.end(),
                [](const auto& a, const auto& b) {
                  return a.first < b.first ||
                         (a.first == b.first && a.second < b.second);
                });
      int32_t cnt = 0;
      for (size_t k = 0; k < buf.size();) {
        int32_t c = buf[k].first;
        double v = 0.0;
        while (k < buf.size() && buf[k].first == c) v += buf[k++].second;
        out_idx[t].push_back(c);
        out_val[t].push_back(v);
        ++cnt;
      }
      out_rcnt[t][r - range[t]] = cnt;
    }
  };
  if (nt == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }

  int64_t out = 0;
  for (int t = 0; t < nt; ++t) out += (int64_t)out_idx[t].size();
  if (out > cap) return -1;

  indptr_c[0] = 0;
  int64_t pos = 0, rr = 0;
  for (int t = 0; t < nt; ++t) {
    std::copy(out_idx[t].begin(), out_idx[t].end(), indices_c + pos);
    std::copy(out_val[t].begin(), out_val[t].end(), data_c + pos);
    pos += (int64_t)out_idx[t].size();
    for (int64_t r = range[t]; r < range[t + 1]; ++r, ++rr)
      indptr_c[rr + 1] = indptr_c[rr] + out_rcnt[t][r - range[t]];
  }
  return out;
}

// Row L1 norms (the L1-Jacobi smoother diagonal). Row-parallel.
void ts_l1_row_norms(int64_t n, const int32_t* indptr, const double* data,
                     double* out) {
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t i = r0; i < r1; ++i) {
      double s = 0.0;
      for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k)
        s += std::fabs(data[k]);
      out[i] = s;
    }
  };
  int64_t nnz = indptr[n];
  int nt = (int)std::min<int64_t>(
      std::max(1u, std::thread::hardware_concurrency()),
      std::max<int64_t>(nnz / (1 << 20), 1));
  if (nt <= 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t)
    threads.emplace_back(work, n * t / nt, n * (t + 1) / nt);
  for (auto& th : threads) th.join();
}

}  // extern "C"
