// Greedy farthest-point sampling: xyz [b, n, 3] -> idx [b, m] int32.
//
// Replaces geoa3_tpu/ops/pallas/fps_kernel.py:_fps_kernel (fps_pallas). The
// first pick is start[b] clamped to [0, n-1] (or index 0); every later pick
// is the point whose running minimum squared distance to the picks so far is
// largest, lowest index on ties. The running minimum starts at 1e10 and is
// updated as `d < cur ? d : cur`. With `skip` set, points with |p|^2 <= 1e-3
// never become candidates; if every point is skipped every pick is index 0,
// as an argmax over all -1 gives. Every product and sum is rounded on its own,
// in the plain version's order: a fused multiply-add would move a running
// minimum by an ulp, and one changed pick changes every later one.
//
// Bound on the H100: by the roofline rule bytes (the cloud read once, the
// indices written once), but that bound is empty here. The work is m-1
// dependent rounds on b of the 132 SMs, and a round costs the latency of its
// chain (distance update, block-wide argmax, the pick's coordinates) plus,
// past ~2048 points, the instructions its scan issues on one SM. The design
// takes both out of the round:
//
//  - Registers. Thread t of the block's T owns P points, j = p*T + t. Their
//    coordinates and running minima stay in registers for all m-1 rounds, so
//    the cloud is read from device memory once. Where P > kRegPoints (past
//    10,240 points, at T = 1024, whose 64 registers a thread hold no more),
//    the coordinates are read from shared memory each round and the minima
//    stay in registers. `fps_plan` picks T and P from n (mirrored by
//    fps_kernel.fps_plan).
//  - A 32-bit score: the running minimum's own bits as a signed int.
//    Distances are >= +0, so their bits order as the floats do, and the
//    update `d < cur ? d : cur` is one integer minimum on the bits. A skipped
//    point's minimum is INT_MIN, which no minimum moves and every candidate
//    beats. Padding slots (j >= n) are skipped points with index kNone, so a
//    skipped real point beats them.
//  - redux.sync. A thread's best is its strictly largest score over its
//    points in ascending index (a tree whose left side holds the lower
//    indices, carrying only the score and p). A warp takes the maximum score
//    with __reduce_max_sync, then the lowest index among the lanes that hold
//    it with __reduce_min_sync.
//  - One barrier a round. Lane 0 of each warp writes the warp's (score,
//    index) to slot[r & 1][warp]; after the one __syncthreads every warp
//    reduces all the slots itself with the same two redux operations, and
//    reads the pick's coordinates from a float4 copy of the cloud in shared
//    memory (one broadcast load), so no thread carries its best point's
//    coordinates through the scan. Every thread learns the pick with no
//    second barrier.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPoints = 14;  // n <= 1024 * 14 = 14336
// The most points a thread keeps in registers (4 words each) at 1024
// threads, 64 registers a thread.
constexpr int kRegPoints = 10;
// The block's width wherever it holds the cloud at kRegPoints points a
// thread (chosen from H100 timings of 128 to 512 threads at n = 512, 1024
// and 2048, in PERF.md); a smaller cloud takes the narrowest width with a
// point a thread, a larger one the narrowest width that holds it.
constexpr int kPlanThreads = 256;
constexpr int kNone = 0x7fffffff;       // a padding slot's index
constexpr int kSkipped = -kNone - 1;    // a skipped point's score (INT_MIN)
// slots: score [2][32], then index [2][32]; then the cloud, float4 [T*P]
constexpr size_t kSlotBytes = 2 * 32 * (4 + 4);

struct FpsPlan {
  int threads, points;
  bool shared;  // coordinates read from shared memory each round
  size_t smem;
};

FpsPlan fps_plan(int n) {
  int t = 32;
  while (t < kMaxThreads && (t < kPlanThreads ? t < n : t * kRegPoints < n))
    t *= 2;
  const int p = (n + t - 1) / t;
  return {t, p, p > kRegPoints, kSlotBytes + (size_t)16 * t * p};
}

template <int P, bool kShared>
__global__ void __launch_bounds__(kMaxThreads, 1)
fps_rounds(const float* __restrict__ xyz, const int* __restrict__ start, int n,
           int m, int skip, int* __restrict__ idx) {
  extern __shared__ __align__(16) float smem[];
  int* slot_score = reinterpret_cast<int*>(smem);
  int* slot_idx = slot_score + 2 * 32;
  float4* cloud_s = reinterpret_cast<float4*>(smem + kSlotBytes / 4);
  const int T = blockDim.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, warps = T >> 5;
  const float* cloud = xyz + (size_t)blockIdx.x * n * 3;
  int* out = idx + (size_t)blockIdx.x * m;

  float px[P], py[P], pz[P];
  int mn[P];  // running minima's bits, or kSkipped
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = p * T + tid;
    const bool real = j < n;
    const float x = real ? cloud[j * 3] : 0.0f;
    const float y = real ? cloud[j * 3 + 1] : 0.0f;
    const float z = real ? cloud[j * 3 + 2] : 0.0f;
    const bool ok = real && (!skip || geoa3_sq3(x, y, z) > 1e-3f);
    mn[p] = ok ? __float_as_int(1e10f) : kSkipped;
    cloud_s[j] = make_float4(x, y, z, 0.0f);
    if constexpr (!kShared) {
      px[p] = x;
      py[p] = y;
      pz[p] = z;
    }
  }
  int s = start ? start[blockIdx.x] : 0;
  s = s < 0 ? 0 : (s >= n ? n - 1 : s);
  if (tid == 0) out[0] = s;
  float lx = cloud[s * 3], ly = cloud[s * 3 + 1], lz = cloud[s * 3 + 2];

  for (int r = 1; r < m; ++r) {
    int sc[P], bp[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if constexpr (kShared) {
        const float4 q = cloud_s[p * T + tid];
        px[p] = q.x;
        py[p] = q.y;
        pz[p] = q.z;
      }
      const int d = __float_as_int(geoa3_sq3(__fsub_rn(px[p], lx),
                                             __fsub_rn(py[p], ly),
                                             __fsub_rn(pz[p], lz)));
      mn[p] = d < mn[p] ? d : mn[p];
      sc[p] = mn[p];
      bp[p] = p;
    }
    // the thread's best in [0]: a right operand (higher indices) wins only
    // with a strictly larger score
#pragma unroll
    for (int h = 1; h < P; h *= 2)
#pragma unroll
      for (int p = 0; p + h < P; p += 2 * h)
        if (sc[p + h] > sc[p]) {
          sc[p] = sc[p + h];
          bp[p] = bp[p + h];
        }
    int j = bp[0] * T + tid;
    if (j >= n) j = kNone;
    const int wbest = __reduce_max_sync(GEOA3_FULL_MASK, sc[0]);
    const int wj = __reduce_min_sync(GEOA3_FULL_MASK, sc[0] == wbest ? j : kNone);
    // Double buffering makes one barrier a round enough: a write to
    // slot[r & 1] in round r comes after its writer passed barrier r-1,
    // which no thread passes before every thread has arrived there, that
    // is, has finished reading slot[r & 1] in round r-2.
    const int buf = (r & 1) * 32;
    if (lane == 0) {
      slot_score[buf + warp] = wbest;
      slot_idx[buf + warp] = wj;
    }
    __syncthreads();
    const int ws = lane < warps ? slot_score[buf + lane] : kSkipped;
    const int wi = lane < warps ? slot_idx[buf + lane] : kNone;
    const int best = __reduce_max_sync(GEOA3_FULL_MASK, ws);
    const int pick = __reduce_min_sync(GEOA3_FULL_MASK, ws == best ? wi : kNone);
    const float4 c = cloud_s[pick];
    lx = c.x;
    ly = c.y;
    lz = c.z;
    if (tid == 0) out[r] = pick;
  }
}

// Launches the instantiation with P == plan.points.
template <int P>
cudaError_t launch_rounds(const FpsPlan& plan, const float* xyz,
                          const int* start, int b, int n, int m, int skip,
                          int* idx, cudaStream_t stream) {
  if constexpr (P < kMaxPoints) {
    if (plan.points != P)
      return launch_rounds<P + 1>(plan, xyz, start, b, n, m, skip, idx, stream);
  }
  constexpr bool kShared = P > kRegPoints;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fps_rounds<P, kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kSlotBytes + (size_t)16 * kMaxThreads * P));
  if (attr != cudaSuccess) return attr;
  fps_rounds<P, kShared><<<b, plan.threads, plan.smem, stream>>>(
      xyz, start, n, m, skip, idx);
  return cudaGetLastError();
}

}  // namespace

// start may be null (every cloud starts at index 0). One launch a call.
extern "C" int geoa3_fps(const float* xyz, const int* start, int b, int n,
                         int m, int skip, int* idx, void* stream) {
  if (b == 0 || m == 0) return 0;
  if (n < 1 || n > kMaxThreads * kMaxPoints) return (int)cudaErrorInvalidValue;
  return (int)launch_rounds<1>(fps_plan(n), xyz, start, b, n, m, skip, idx,
                               static_cast<cudaStream_t>(stream));
}
