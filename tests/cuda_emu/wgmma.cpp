// Runs the wgmma stand-in of cuda_runtime.h alone, on the operands as
// csrc/pool_matmul_bf16.cu lays them out (its stage_weights, w_fragment,
// stage_operand and gmma_desc):
//
//   wgmma in.bin out.bin K [N]
//
// in.bin holds W [K, 128] and x [N, K] (bf16 as uint16; N is 64, 128 or
// 256, 64 unless given). One warpgroup stages W as a block's weights and x
// as a landed tile's operand, takes A = W^T's fragments for channels 64 ..
// 127 by ldmatrix.trans, and runs K / 16 wgmma m64nNk16 (at N = 64
// wgmma_m64n64k16_bf16, else wgmma_bf16<N>) with B = x^T K-major, the first
// step without the accumulators' old value, each step its own group,
// retired together; it writes D [64 channels, N points] (float32). Exits 1
// where a stand-in aborts.
#include "pool_matmul_bf16_emu.cpp"  // the kernel source, rewritten by the test

template <int N>
void run(int K, const std::vector<uint16_t>& Wt, const std::vector<uint16_t>& x,
         std::vector<float>& D) {
  const size_t wbytes = (size_t)K * (2 * 128 + 16), xbytes = (size_t)N * K * 2;
  emu_launch(std::make_tuple(dim3(1), 128, wbytes + 2 * xbytes), [&]() {
    char* W = reinterpret_cast<char*>(smem);
    char* land = W + wbytes;
    char* B = land + xbytes;
    stage_weights<128>(W, Wt.data(), K, 128, 0);
    for (int i = threadIdx.x; i < N * K / 8; i += 128)
      memcpy(land + (size_t)i * 16, x.data() + (size_t)i * 8, 16);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    stage_operand<uint16_t, 0>(B, land, N, K, 0, N, threadIdx.x);
    fence_proxy_async();
    __syncthreads();
    const int w = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    float acc[N / 2];
    for (float& v : acc) v = 1e30f;  // dropped by the first step
    uint32_t a[8][4];
    for (int s = 0; s < K / 16; ++s) {
      w_fragment<128>(a[s], W, 16 * s, 64 + 16 * w, lane);
      wgmma_fence();
      const uint64_t desc = gmma_desc(smem_addr(B) + 2 * s * N * 16, N * 16, 128);
      if constexpr (N == 64)
        wgmma_m64n64k16_bf16(acc, a[s], desc, s > 0);
      else
        wgmma_bf16<N>(acc, a[s], desc, s > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
    for (int i = 0; i < N / 2; ++i) {
      const int j = i / 4, h = (i / 2) % 2, e = i % 2;
      D[(size_t)(16 * w + g + 8 * h) * N + 8 * j + 2 * q + e] = acc[i];
    }
  });
}

int main(int argc, char** argv) {
  if (argc < 4) return 2;
  const int K = atoi(argv[3]), N = argc > 4 ? atoi(argv[4]) : 64;
  if (K % 16 || K > 128 || (N != 64 && N != 128 && N != 256)) return 2;
  std::vector<uint16_t> Wt((size_t)K * 128), x((size_t)N * K);
  std::vector<float> D((size_t)64 * N, NAN);
  FILE* in = fopen(argv[1], "rb");
  if (!in || fread(Wt.data(), 2, Wt.size(), in) != Wt.size() ||
      fread(x.data(), 2, x.size(), in) != x.size())
    return 2;
  fclose(in);
  if (N == 64) run<64>(K, Wt, x, D);
  if (N == 128) run<128>(K, Wt, x, D);
  if (N == 256) run<256>(K, Wt, x, D);
  FILE* out = fopen(argv[2], "wb");
  if (!out || fwrite(D.data(), 4, D.size(), out) != D.size()) return 2;
  fclose(out);
  return 0;
}
