// Runs csrc/pool_matmul_bf16.cu's two kernels on the CPU (through
// cuda_runtime.h) on inputs read from a file, and writes their outputs to
// another:
//
//   pool_bf16 in.bin out.bin B n cin cout taps x_bf16
//   pool_bf16 plan - B n cin cout taps x_bf16   (prints the forward's
//                                               plan only: consumer
//                                               warpgroups, shared memory)
//
// in.bin holds x [B, n, cin] (bf16 as uint16 where x_bf16 is 1, else
// float32), w3 [taps, cin, cout] (bf16 as uint16), bias [cout] and the
// pooled cotangent g [B, cout] (float32). The program runs
// geoa3_pool_fwd_bf16, then geoa3_pool_bwd_bf16 on its outputs (w3t made
// here), and writes pooled [B, cout] (float32), cnt [B, cout] and rows
// [B, cout, 4] (int32), then dx [B, n, cin] (float32). The outputs start as
// NaN (or -1), so an element left unwritten shows, and the 16 guard values
// past each must stay as they were. Exits 1 if an entry refused the call or
// wrote past an output.
#include "pool_matmul_bf16_emu.cpp"  // the kernel source, rewritten by the test

#include <string>

namespace {

constexpr int kGuard = 16;
constexpr int kGuardBits = 0x7eadbeef;

template <class T>
T* guarded(size_t count, T fill) {
  T* p = new T[count + kGuard];
  for (size_t i = 0; i < count; ++i) p[i] = fill;
  for (size_t i = count; i < count + kGuard; ++i) memcpy(&p[i], &kGuardBits, 4);
  return p;
}

template <class T>
bool intact(const T* p, size_t count, const char* what) {
  for (size_t i = count; i < count + kGuard; ++i)
    if (memcmp(&p[i], &kGuardBits, 4) != 0) {
      printf("wrote past %s's end at [%zu]\n", what, i);
      return false;
    }
  return true;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 9) return 2;
  const int B = atoi(argv[3]), n = atoi(argv[4]), cin = atoi(argv[5]);
  const int cout = atoi(argv[6]), taps = atoi(argv[7]), x_bf16 = atoi(argv[8]);
  if (std::string(argv[1]) == "plan") {
    const FwdPlan p = pool_bf16_plan(cin, cout, taps, x_bf16 ? 2 : 4);
    printf("nwg=%d smem=%zu\n", p.nwg, p.smem);
    return 0;
  }
  const size_t nx = (size_t)B * n * cin, nw = (size_t)taps * cin * cout;
  const size_t no = (size_t)B * cout;
  std::vector<char> x(nx * (x_bf16 ? 2 : 4));
  std::vector<uint16_t> w3(nw), w3t(nw);
  std::vector<float> bias(cout), g(no);
  FILE* in = fopen(argv[1], "rb");
  if (!in || fread(x.data(), 1, x.size(), in) != x.size() ||
      fread(w3.data(), 2, nw, in) != nw ||
      fread(bias.data(), 4, cout, in) != (size_t)cout ||
      fread(g.data(), 4, no, in) != no)
    return 2;
  fclose(in);
  for (int t = 0; t < taps; ++t)
    for (int k = 0; k < cin; ++k)
      for (int c = 0; c < cout; ++c)
        w3t[((size_t)t * cout + c) * cin + k] = w3[((size_t)t * cin + k) * cout + c];

  float* pooled = guarded<float>(no, NAN);
  int* cnt = guarded<int>(no, -1);
  int* rows = guarded<int>(no * 4, -1);
  float* dx = guarded<float>(nx, NAN);
  int err = geoa3_pool_fwd_bf16(x.data(), w3.data(), bias.data(), B, n, cin,
                                cout, taps, x_bf16, pooled, cnt, rows, nullptr);
  if (err != 0) {
    printf("geoa3_pool_fwd_bf16 refused the call: %d\n", err);
    return 1;
  }
  err = geoa3_pool_bwd_bf16(w3t.data(), g.data(), cnt, rows, x.data(),
                            bias.data(), pooled, w3.data(), B, n, cin, cout,
                            taps, x_bf16, dx, nullptr);
  if (err != 0) {
    printf("geoa3_pool_bwd_bf16 refused the call: %d\n", err);
    return 1;
  }
  if (!intact(pooled, no, "pooled") || !intact(cnt, no, "cnt") ||
      !intact(rows, no * 4, "rows") || !intact(dx, nx, "dx"))
    return 1;
  FILE* out = fopen(argv[2], "wb");
  if (!out || fwrite(pooled, 4, no, out) != no || fwrite(cnt, 4, no, out) != no ||
      fwrite(rows, 4, no * 4, out) != no * 4 || fwrite(dx, 4, nx, out) != nx)
    return 2;
  fclose(out);
  return 0;
}
