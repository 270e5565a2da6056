// Fused quorum reduction of the raft tick, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   tpuraft/ops/quorum_pallas.py::_fused_quorum_pallas (pl.pallas_call),
//   body _fused_quorum_kernel, helpers _qth_largest and _vote_quorum.
//
// For each raft group g (one row of the [G, P] state planes) it computes,
// joint-consensus aware (a row is joint when any old-config voter is set):
//   quorum_idx[g]  q-th largest voter match, q = n_voters / 2 + 1,
//                  -2^30 for a row without voters; joint: min of both configs
//   elected[g]     granted voters >= q; joint: in both configs
//   q_ack[g]       the same order statistic over last_ack
// The order statistic equals the sort-based oracle (tpuraft_torch/ops/
// ballot.py) bit for bit: masked-out slots take the value -2^30, the row
// of all P slots is ranked, and the value at sorted position q-1 is
// picked.  Rank counting finds it without a sort: the q-th largest of a
// multiset w is max{ w_j : #{k : w_k >= w_j} >= q }.
//
// Layout and design: the port's public [G, P] row-major layout as it is.
// One thread per group; its P-slot rows live in registers.  P is a
// template parameter (1..32, one instantiation each), so every loop
// unrolls.  Bool planes are read as bytes (torch.bool is one byte) and
// packed into 32-bit masks; a warp reads 32 consecutive rows, which are
// contiguous bytes.  When P is a multiple of 4 and the pointers are
// aligned, rows load as 16-byte (int32) and 4-byte (bool) vectors; that
// choice is a runtime flag, which keeps the nvcc build short.  The vector
// loads are worth their branch: on an H100 a build with scalar loads only
// took 25 % more device time per launch at P = 8 and 34 % more at P = 16
// (bench_torch_tick.py).  The last
// block bounds-checks its ragged end.  The kernel allocates nothing and
// does not synchronise; the wrapper (tpuraft_torch/ops/quorum_cuda.py)
// allocates the outputs and launches on PyTorch's current stream.
//
// Bound on an H100 SXM: the work is memory-bound.  It reads 2 int32 and
// 3 bool planes (11 * G * P bytes) and writes 2 int32 and 1 bool rows
// (9 * G bytes): 1.59 MB at G = 16,384, P = 8, about 0.47 us at 3.35 TB/s.
// The arithmetic (O(P^2) integer compares per row) is negligible, so at
// these sizes the launch latency dominates.  Making it fast is later
// work: fusing the whole tick into one launch, and CUDA graphs for it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kNegInf = -(1 << 30);
constexpr int kThreads = 128;

template <int P>
__device__ __forceinline__ void load_row_i32(const int32_t* __restrict__ row,
                                             int32_t (&v)[P], bool vec) {
  if (P % 4 == 0 && vec) {
    const int4* p = reinterpret_cast<const int4*>(row);
#pragma unroll
    for (int i = 0; i < P / 4; ++i) {
      const int4 t = __ldg(p + i);
      v[4 * i + 0] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k) v[k] = __ldg(row + k);
  }
}

template <int P>
__device__ __forceinline__ uint32_t load_row_mask(
    const uint8_t* __restrict__ row, bool vec) {
  uint32_t m = 0;
  if (P % 4 == 0 && vec) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row);
#pragma unroll
    for (int i = 0; i < P / 4; ++i) {
      const uint32_t w = __ldg(p + i);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((w >> (8 * b)) & 0xffu) m |= 1u << (4 * i + b);
    }
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (__ldg(row + k)) m |= 1u << k;
  }
  return m;
}

// q-th largest of the row with slots outside `mask` set to kNegInf,
// q = n / 2 + 1 with n = popcount(mask); kNegInf when n == 0.
template <int P>
__device__ __forceinline__ int32_t qth_largest(const int32_t (&v)[P],
                                               uint32_t mask) {
  const int n = __popc(mask);
  if (n == 0) return kNegInf;
  const int q = n / 2 + 1;
  int32_t w[P];
#pragma unroll
  for (int k = 0; k < P; ++k) w[k] = ((mask >> k) & 1u) ? v[k] : kNegInf;
  int32_t best = INT32_MIN;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < P; ++k) c += (w[k] >= w[j]) ? 1 : 0;
    if (c >= q && w[j] > best) best = w[j];
  }
  return best;
}

__device__ __forceinline__ bool vote_quorum(uint32_t granted, uint32_t mask) {
  const int n = __popc(mask);
  return n > 0 && __popc(granted & mask) >= n / 2 + 1;
}

// vec: rows load as 16-byte / 4-byte vectors (P % 4 == 0, aligned
// pointers); a uniform runtime branch, so one instantiation per P.
template <int P>
__global__ void __launch_bounds__(kThreads) fused_quorum_kernel(
    const int32_t* __restrict__ match, const uint8_t* __restrict__ granted,
    const int32_t* __restrict__ last_ack,
    const uint8_t* __restrict__ voter_mask,
    const uint8_t* __restrict__ old_voter_mask, int32_t* __restrict__ qidx,
    uint8_t* __restrict__ elected, int32_t* __restrict__ qack, int G,
    bool vec) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= G) return;
  const size_t off = static_cast<size_t>(g) * P;

  const uint32_t vm = load_row_mask<P>(voter_mask + off, vec);
  const uint32_t ovm = load_row_mask<P>(old_voter_mask + off, vec);
  const uint32_t gr = load_row_mask<P>(granted + off, vec);
  const bool in_joint = ovm != 0u;

  int32_t v[P];
  load_row_i32<P>(match + off, v, vec);
  int32_t qi = qth_largest<P>(v, vm);
  if (in_joint) qi = min(qi, qth_largest<P>(v, ovm));

  load_row_i32<P>(last_ack + off, v, vec);
  int32_t qa = qth_largest<P>(v, vm);
  if (in_joint) qa = min(qa, qth_largest<P>(v, ovm));

  bool el = vote_quorum(gr, vm);
  if (in_joint) el = el && vote_quorum(gr, ovm);

  qidx[g] = qi;
  qack[g] = qa;
  elected[g] = el ? 1 : 0;
}

template <int P>
cudaError_t launch(const int32_t* match, const uint8_t* granted,
                   const int32_t* last_ack, const uint8_t* voter_mask,
                   const uint8_t* old_voter_mask, int32_t* qidx,
                   uint8_t* elected, int32_t* qack, int G, bool vec,
                   cudaStream_t stream) {
  const dim3 grid((G + kThreads - 1) / kThreads);
  fused_quorum_kernel<P><<<grid, kThreads, 0, stream>>>(
      match, granted, last_ack, voter_mask, old_voter_mask, qidx, elected,
      qack, G, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tpuraft_fused_quorum_max_peers() { return 32; }

// Returns cudaSuccess (0) or the launch error; G == 0 launches nothing.
extern "C" cudaError_t tpuraft_fused_quorum(
    const int32_t* match, const uint8_t* granted, const int32_t* last_ack,
    const uint8_t* voter_mask, const uint8_t* old_voter_mask, int32_t* qidx,
    uint8_t* elected, int32_t* qack, int G, int P, cudaStream_t stream) {
  if (G < 0) return cudaErrorInvalidValue;
  if (G == 0) return cudaSuccess;
  const uintptr_t i32 = reinterpret_cast<uintptr_t>(match) |
                        reinterpret_cast<uintptr_t>(last_ack);
  const uintptr_t u8 = reinterpret_cast<uintptr_t>(granted) |
                       reinterpret_cast<uintptr_t>(voter_mask) |
                       reinterpret_cast<uintptr_t>(old_voter_mask);
  const bool vec = (P % 4 == 0) && (i32 % 16 == 0) && (u8 % 4 == 0);
  switch (P) {
#define TPURAFT_CASE(N)                                                    \
  case N:                                                                  \
    return launch<N>(match, granted, last_ack, voter_mask, old_voter_mask, \
                     qidx, elected, qack, G, vec, stream);
    TPURAFT_CASE(1) TPURAFT_CASE(2) TPURAFT_CASE(3) TPURAFT_CASE(4)
    TPURAFT_CASE(5) TPURAFT_CASE(6) TPURAFT_CASE(7) TPURAFT_CASE(8)
    TPURAFT_CASE(9) TPURAFT_CASE(10) TPURAFT_CASE(11) TPURAFT_CASE(12)
    TPURAFT_CASE(13) TPURAFT_CASE(14) TPURAFT_CASE(15) TPURAFT_CASE(16)
    TPURAFT_CASE(17) TPURAFT_CASE(18) TPURAFT_CASE(19) TPURAFT_CASE(20)
    TPURAFT_CASE(21) TPURAFT_CASE(22) TPURAFT_CASE(23) TPURAFT_CASE(24)
    TPURAFT_CASE(25) TPURAFT_CASE(26) TPURAFT_CASE(27) TPURAFT_CASE(28)
    TPURAFT_CASE(29) TPURAFT_CASE(30) TPURAFT_CASE(31) TPURAFT_CASE(32)
#undef TPURAFT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
