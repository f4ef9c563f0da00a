// The escape tallies of a segment's finished lanes for NVIDIA Hopper
// (sm_90a): the four binned sums of ops/finish.py finish_particles
// (esc_psd_dw, esc_psd_up, esc_energy_eff, esc_num_eff) in one call.
//
// Replaces no Pallas kernel: the JAX package leaves these scatter-adds to
// XLA (montecarloscattering_jl_tpu/ops/finish.py finish_particles).  On a
// card the port ran them as four accumulating index_put_ calls, each a
// radix sort and a kernel that sends one warp down each run of equal
// cells; every lane of the batch enters all four, most with a zero addend
// (lanes that did not finish by the tally's reason, zero-weight padding,
// every lane of a dead segment), and the runs are thousands of entries
// long (the 1-D tallies put every lane into n_mom + 1 cells).  Here:
//   * a lane makes at most two records: (its 2-D cell in the downstream
//     or the upstream tally, its wwf addend), and for an upstream lane
//     (its momentum bin, its we and wd addends).  A record whose addends
//     are all zero is dropped: every addend is >= 0 and every tally
//     starts at +0.0, so a zero changes no sum.  The keys: downstream
//     cells [0, C), upstream cells [C, 2 C), momentum bins [2 C, 2 C +
//     n_mom + 1), C = (n_mom + 1) (n_theta + 1); the sentinel 2 C + n_mom
//     + 1 marks an empty slot.  A lane is downstream or upstream, not
//     both (one exit reason a lane);
//   * kernel 1, a block a chunk of kChunk lanes, a thread kLanes
//     consecutive lanes: the thread first adds its records of one key in
//     lane order (level 0), then the block sorts its records by key with
//     cub's stable BlockRadixSort, so one key's records stand in thread
//     order, and the thread at the head of each key's run adds them in
//     that order (level 1) into the chunk's record of the key, written
//     to scratch with the chunk's count of records;
//   * kernel 2, one block on the same stream: the chunks in order, each
//     chunk's records added into the tallies in parallel (a chunk holds a
//     key once), a barrier between chunks (level 2).
// So each cell sums in a fixed order of its own: tally + P_0 + P_1 + ...
// over the chunks that touch it in chunk order, P_c the sum over the
// chunk's kLanes-lane groups in group order, each group's sum its lanes'
// nonzero addends in lane order.  The order depends on the lanes' indices
// and never on where the zero addends lie; no float atomics, so two
// launches on one input give the same bits.  ops/finish.py tally_twin
// sums in the same order in plain torch.  A lane whose bins lie outside
// the tallies adds nothing (the binning clamps, so none does).
// Bound: bytes, the two flags of every lane, a downstream finisher's two
// int64 bins and wwf (24), an upstream one's bins, wwf, we and wd (40),
// and each touched cell read and written, under 1 us at 65,536 lanes;
// the kernels are bound by latency (the block sort, the serial runs of at
// most kThreads fragments, kernel 2's chain of chunks).  They allocate nothing and
// launch on the caller's stream; the C entry point returns
// cudaGetLastError() of the launches.

#include <cuda_runtime.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;                // kernel 1's block
constexpr int kLanes = 4;                    // consecutive lanes a thread
constexpr int kChunk = kThreads * kLanes;    // lanes a block
constexpr int kItems = 2 * kLanes;           // records a thread
constexpr int kSlots = kThreads * kItems;    // records a chunk at most
constexpr int kApplyThreads = 1024;          // kernel 2's block

struct FinishArgs {
  const long long* ip;     // [n] momentum bins
  const long long* jt;     // [n] angle bins
  const bool* is_dw;       // [n] finished downstream
  const bool* is_up;       // [n] finished upstream or past pmax
  const double* wwf;       // [n] the 2-D tallies' addend
  const double* we;        // [n] esc_energy_eff's addend
  const double* wd;        // [n] esc_num_eff's addend
  double* psd_dw;          // [n_mom + 1, n_theta + 1]
  double* psd_up;          // [n_mom + 1, n_theta + 1]
  double* energy;          // [n_mom + 1]
  double* num;             // [n_mom + 1]
  int* counts;             // [n_chunks] scratch: records a chunk
  unsigned* keys;          // [n_chunks, kSlots] scratch
  double2* vals;           // [n_chunks, kSlots] scratch
  long long n;
  int n_mom1, n_theta1;
  unsigned cells, sentinel;
  int end_bit;
};

__global__ void __launch_bounds__(kThreads)
finish_chunks(const FinishArgs a) {
  using Sort = cub::BlockRadixSort<unsigned, kThreads, kItems,
                                   unsigned short>;
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ double2 frag[kSlots];           // level-0 sums by slot
  __shared__ union {
    typename Sort::TempStorage sort;
    struct {
      unsigned key[kSlots];                  // sorted keys
      unsigned short at[kSlots];             // their slots in frag
    } run;
  } sm;
  __shared__ typename Scan::TempStorage scan;

  const int t = threadIdx.x;
  const long long lane0 = (long long)blockIdx.x * kChunk + t * kLanes;
  unsigned key[kItems];
  unsigned short at[kItems];
  double2 v[kItems];
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    key[i] = key[kLanes + i] = a.sentinel;
    v[i] = v[kLanes + i] = make_double2(0.0, 0.0);
    const long long l = lane0 + i;
    if (l >= a.n) continue;
    const bool up = a.is_up[l];
    if (!up && !a.is_dw[l]) continue;
    const long long ip = a.ip[l], jt = a.jt[l];
    if (ip < 0 || ip >= a.n_mom1 || jt < 0 || jt >= a.n_theta1) continue;
    const double x = a.wwf[l];
    if (x != 0.0) {
      key[i] = (up ? a.cells : 0u) + (unsigned)(ip * a.n_theta1 + jt);
      v[i].x = x;
    }
    if (up) {
      const double e = a.we[l], d = a.wd[l];
      if (e != 0.0 || d != 0.0) {
        key[kLanes + i] = 2u * a.cells + (unsigned)ip;
        v[kLanes + i] = make_double2(e, d);
      }
    }
  }
  // level 0: a key's records of this thread into its first slot, in lane
  // order (the 2-D and the 1-D keys never meet)
#pragma unroll
  for (int i = 1; i < kItems; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) {
      if (key[i] != a.sentinel && key[j] == key[i]) {
        v[j].x += v[i].x;
        v[j].y += v[i].y;
        key[i] = a.sentinel;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    at[i] = (unsigned short)(t * kItems + i);
    frag[t * kItems + i] = v[i];
  }
  // stable: one key's records in thread order, the empty slots last
  Sort(sm.sort).Sort(key, at, 0, a.end_bit);
  __syncthreads();                           // the sort's storage is reused
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    sm.run.key[t * kItems + i] = key[i];
    sm.run.at[t * kItems + i] = at[i];
  }
  __syncthreads();
  bool head[kItems];
  int heads = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int p = t * kItems + i;
    head[i] = key[i] != a.sentinel && (p == 0 || sm.run.key[p - 1] != key[i]);
    heads += head[i];
  }
  int out, total;
  Scan(scan).ExclusiveSum(heads, out, total);
  // level 1: a run's fragments in sorted order, at most one a thread
  const long long base = (long long)blockIdx.x * kSlots;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (!head[i]) continue;
    double2 s = frag[at[i]];
    for (int q = t * kItems + i + 1; q < kSlots && sm.run.key[q] == key[i];
         ++q) {
      const double2 f = frag[sm.run.at[q]];
      s.x += f.x;
      s.y += f.y;
    }
    a.keys[base + out] = key[i];
    a.vals[base + out] = s;
    ++out;
  }
  if (t == 0) a.counts[blockIdx.x] = total;
}

__device__ __forceinline__ void apply(const FinishArgs& a, unsigned k,
                                      double2 s) {
  if (k < a.cells) {
    a.psd_dw[k] += s.x;
  } else if (k < 2u * a.cells) {
    a.psd_up[k - a.cells] += s.x;
  } else {
    a.energy[k - 2u * a.cells] += s.x;
    a.num[k - 2u * a.cells] += s.y;
  }
}

// level 2: the chunks in order; within one, every key once.  The next
// chunk's count and first records are read ahead of the barrier (a slot
// past a chunk's count is read and not used).
__global__ void __launch_bounds__(kApplyThreads)
finish_apply(const FinishArgs a, int n_chunks) {
  const int t = threadIdx.x;
  int cnt = a.counts[0];
  unsigned k = a.keys[t];
  double2 s = a.vals[t];
  for (int c = 0; c < n_chunks; ++c) {
    int cnt_n = 0;
    unsigned k_n = 0;
    double2 s_n = make_double2(0.0, 0.0);
    if (c + 1 < n_chunks) {
      const long long nx = (long long)(c + 1) * kSlots + t;
      cnt_n = a.counts[c + 1];
      k_n = a.keys[nx];
      s_n = a.vals[nx];
    }
    if (t < cnt) apply(a, k, s);
    for (int j = t + kApplyThreads; j < cnt; j += kApplyThreads) {
      const long long at = (long long)c * kSlots + j;
      apply(a, a.keys[at], a.vals[at]);
    }
    __syncthreads();
    cnt = cnt_n;
    k = k_n;
    s = s_n;
  }
}

}  // namespace

// One call: kernel 1 on ceil(n / kChunk) blocks, then kernel 2 on one.
// `counts`, `keys` and `vals` are the caller's scratch of ceil(n /
// kChunk) ints, and that many times kSlots keys and double2 values.
extern "C" int mcs_finish_tally(const long long* ip, const long long* jt,
                                const bool* is_dw, const bool* is_up,
                                const double* wwf, const double* we,
                                const double* wd, double* psd_dw,
                                double* psd_up, double* energy, double* num,
                                int* counts, unsigned* keys, double* vals,
                                long long n, int n_mom1, int n_theta1,
                                void* stream) {
  if (n <= 0) return 0;
  const long long cells = (long long)n_mom1 * n_theta1;
  if (n_mom1 < 1 || n_theta1 < 1 || 2 * cells + n_mom1 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  FinishArgs a;
  a.ip = ip;
  a.jt = jt;
  a.is_dw = is_dw;
  a.is_up = is_up;
  a.wwf = wwf;
  a.we = we;
  a.wd = wd;
  a.psd_dw = psd_dw;
  a.psd_up = psd_up;
  a.energy = energy;
  a.num = num;
  a.counts = counts;
  a.keys = keys;
  a.vals = reinterpret_cast<double2*>(vals);
  a.n = n;
  a.n_mom1 = n_mom1;
  a.n_theta1 = n_theta1;
  a.cells = (unsigned)cells;
  a.sentinel = (unsigned)(2 * cells + n_mom1);
  a.end_bit = 0;
  while ((1ULL << a.end_bit) <= a.sentinel) ++a.end_bit;
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > (1LL << 30)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  finish_chunks<<<(unsigned)n_chunks, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_apply<<<1, kApplyThreads, 0, s>>>(a, (int)n_chunks);
  return (int)cudaGetLastError();
}
