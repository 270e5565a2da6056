// Earliest engine-scheduled deadline of one shard for Hopper (sm_90a): the
// masked min the engine's loop sleeps toward, in one launch.
//
// For each group row i (int32 rows, bool rows one byte each):
//   awake = has_ctrl[i] && !quiescent[i]
//   role[i] <= 1 (follower, candidate): elect_deadline[i]
//   role[i] == 2 (leader):              min(hb_deadline[i], stepdown_deadline[i])
// and the result is the min over the awake rows' deadlines, INT32_MAX (the
// "none" sentinel, DEADLINE_NONE_I32) when no row schedules anything.
//
// Layout: a grid-stride loop over the rows (each warp reads 32 neighbouring
// words of every row, coalesced), a warp-shuffle min, a block min through
// shared memory, then one atomicMin per block.  The atomics run on an
// order-preserving key, x ^ 0x80000000 as uint32, so the sentinel's key is
// 0xFFFFFFFF.  A ticket counter finds the last block, which writes the
// decoded min.  A min is exact whatever order the atomics take.
//
// out[0] receives the min; out[1] (the key) and out[2] (the ticket) are
// scratch that rests at 0xFFFFFFFF between folds: the last block takes the
// key with an atomic exchange that resets it and resets the ticket, so the
// next fold on the stream (a kernel boundary later) finds both at rest.
// One fold is one kernel node, with no memset before it; whoever allocates
// the buffer sets the rest state once (tpuraft_torch/ops/deadline_fold.py::
// fold_work_buffer).
//
// Bound: bytes, G * 18 read (four int32 rows, two bool rows) and 4 written
// (0.35 us at G=65,536 on an H100's 3.35 TB/s); at a shard's size the
// launch itself is most of the time.
//
// Replaces the XLA program of the JAX package's sharded_deadline_fold
// (tpuraft/parallel/mesh.py: the masked jnp.min on each shard), one launch
// per shard; the collective min over the shards is a host min of N values.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1056;  // 132 SMs x 8 resident blocks
constexpr uint32_t kFlip = 0x80000000u;
constexpr uint32_t kRest = 0xFFFFFFFFu;  // the key's and the ticket's rest

__device__ __forceinline__ int32_t row_deadline(int32_t role, uint8_t quiescent,
                                                uint8_t has_ctrl, int32_t elect,
                                                int32_t hb, int32_t stepdown) {
  if (!has_ctrl || quiescent) return INT32_MAX;
  if (role <= 1) return elect;
  if (role == 2) return min(hb, stepdown);
  return INT32_MAX;
}

__global__ void __launch_bounds__(kThreads)
    deadline_fold_kernel(const int32_t* __restrict__ role,
                         const uint8_t* __restrict__ quiescent,
                         const uint8_t* __restrict__ has_ctrl,
                         const int32_t* __restrict__ elect,
                         const int32_t* __restrict__ hb,
                         const int32_t* __restrict__ stepdown,
                         int32_t* __restrict__ out, int G) {
  int32_t m = INT32_MAX;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < G;
       i += gridDim.x * kThreads) {
    m = min(m, row_deadline(__ldg(role + i), __ldg(quiescent + i),
                            __ldg(has_ctrl + i), __ldg(elect + i),
                            __ldg(hb + i), __ldg(stepdown + i)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = min(m, __shfl_down_sync(0xffffffffu, m, o));
  __shared__ int32_t warp_min[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_min[warp] = m;
  __syncthreads();
  if (warp != 0) return;
  m = lane < kWarps ? warp_min[lane] : INT32_MAX;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = min(m, __shfl_down_sync(0xffffffffu, m, o));
  if (lane != 0) return;
  uint32_t* key = reinterpret_cast<uint32_t*>(out + 1);
  uint32_t* ticket = reinterpret_cast<uint32_t*>(out + 2);
  atomicMin(key, static_cast<uint32_t>(m) ^ kFlip);
  __threadfence();
  // the ticket rests at 0xFFFFFFFF: the last of gridDim.x blocks draws
  // gridDim.x - 2 (mod 2^32), after every other block's atomicMin
  if (atomicAdd(ticket, 1u) == static_cast<uint32_t>(gridDim.x) - 2u) {
    __threadfence();
    out[0] = static_cast<int32_t>(atomicExch(key, kRest) ^ kFlip);
    atomicExch(ticket, kRest);
  }
}

}  // namespace

extern "C" int tpuraft_deadline_fold(const int32_t* role,
                                     const uint8_t* quiescent,
                                     const uint8_t* has_ctrl,
                                     const int32_t* elect, const int32_t* hb,
                                     const int32_t* stepdown, int32_t* out,
                                     int G, cudaStream_t stream) {
  // the grid-stride index stays below 2^31
  if (G < 0 || G > INT32_MAX - kMaxBlocks * kThreads)
    return cudaErrorInvalidValue;
  int blocks = (G + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;  // G == 0: the one block writes the sentinel
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  deadline_fold_kernel<<<blocks, kThreads, 0, stream>>>(
      role, quiescent, has_ctrl, elect, hb, stepdown, out, G);
  return cudaGetLastError();
}
