// The unit map shared by the exact-list kernels (lj_cluster_ilist.cu,
// eam_cluster.cu): which unit a list row belongs to, and how many of its
// entries the unit reads, on the flat form and on the capacity-bucketed
// form (lists in nji-sorted order; see lj_cluster_ilist.cu's header).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace unit_map {

constexpr int kMaxBuckets = 32;  // the most buckets a launch takes

// The bucketed form's position ranges [end[k-1], end[k]) and caps, passed
// by value; n = 0 on the flat form.
struct Buckets {
  int n;
  int end[kMaxBuckets];
  int cap[kMaxBuckets];
};

// Host side: the table from the caller's arrays, or false if it does not
// fit (n < 1, n > kMaxBuckets, a negative cap, ends not ascending, or the
// last end not n_rows).
inline bool make_buckets(int n, const int* ends, const int* caps, int n_rows,
                         Buckets& bk) {
  if (n < 1 || n > kMaxBuckets || ends == nullptr || caps == nullptr) return false;
  bk.n = n;
  int prev = 0;
  for (int k = 0; k < n; ++k) {
    if (caps[k] < 0 || ends[k] < prev) return false;
    bk.end[k] = prev = ends[k];
    bk.cap[k] = caps[k];
  }
  return prev == n_rows;
}

// The unit whose list is row s (-1: none), and in `cap` the most entries
// it reads. Flat (bcrows null): unit s, cap icap. Bucketed: the unit of
// cluster row bcrows[s*share] (-1 for a dummy unit, whose row lies past
// n_units*share) and min(icap, its bucket's cap).
__device__ __forceinline__ int unit_of(int s, int n_rows, int n_units, int share,
                                       int icap, const int32_t* __restrict__ bcrows,
                                       const Buckets& bk, int& cap) {
  cap = icap;
  if (s >= n_rows) return -1;
  if (bcrows == nullptr) return s;
  // unrolled with constant indices, so the table stays in the parameter
  // bank (a dynamic index would copy it to local memory)
  int c = bk.cap[0];
#pragma unroll
  for (int k = 0; k < kMaxBuckets - 1; ++k) {
    if (k < bk.n - 1 && s >= bk.end[k]) c = bk.cap[k + 1];
  }
  cap = min(cap, c);
  const int c0 = bcrows[static_cast<int64_t>(s) * share];
  return (c0 >= 0 && c0 < n_units * share) ? c0 / share : -1;
}

}  // namespace unit_map
