// Runs csrc/pool_matmul.cu's two kernels (the float32 pool forward and the
// gather of csrc/pool_gather.cuh) on the CPU, through cuda_runtime.h, on
// inputs read from a file, and writes their outputs to another:
//
//   pool_f32 in.bin out.bin B n cin cout taps
//   pool_f32 plan - B n cin cout taps     (prints the forward's shared memory
//                                          at cin, and the backward's tile:
//                                          rows, warps, entries kept, shared
//                                          memory)
//   pool_f32 accepts - max_cin max_cout   (calls geoa3_pool_bwd at B = 0 for
//                                          every cin % 16 == 0 up to max_cin,
//                                          cout % 128 == 0 up to max_cout and
//                                          taps 1 and 3, and prints the shapes
//                                          it refused, then their count)
//
// in.bin holds x [B, n, cin], w3 [taps, cin, cout], bias [cout] and the
// pooled cotangent g [B, cout], all float32. The program runs
// geoa3_pool_fwd, then geoa3_pool_bwd on its outputs (w3t made here), and
// writes pooled [B, cout] (float32), cnt [B, cout] and rows [B, cout, 4]
// (int32), then dx [B, n, cin] (float32). The outputs start as NaN (or -1),
// so an element left unwritten shows (dx has no memset), the 16 guard values
// past each must stay as they were, and the backward's bulk copies may read
// only g, cnt and rows. Exits 1 if an entry refused the call or wrote past
// an output.
#include "pool_matmul_emu.cpp"  // the kernel source, rewritten by the test

#include <string>

namespace {

constexpr int kGuard = 16;
constexpr int kGuardBits = 0x7eadbeef;

template <class T>
T* guarded(size_t count, T fill) {
  T* p = new (std::align_val_t(16)) T[count + kGuard];
  for (size_t i = 0; i < count; ++i) p[i] = fill;
  for (size_t i = count; i < count + kGuard; ++i) memcpy(&p[i], &kGuardBits, sizeof(T));
  return p;
}

template <class T>
bool intact(const T* p, size_t count, const char* what) {
  for (size_t i = count; i < count + kGuard; ++i)
    if (memcmp(&p[i], &kGuardBits, sizeof(T)) != 0) {
      printf("wrote past %s's end at [%zu]\n", what, i);
      return false;
    }
  return true;
}

template <class T>
const char* end_of(const T* p, size_t count) {
  return reinterpret_cast<const char*>(p + count);
}

}  // namespace

int main(int argc, char** argv) {
  const std::string mode = argc > 1 ? argv[1] : "";
  if (mode == "accepts" && argc >= 5) {
    const int max_cin = atoi(argv[3]), max_cout = atoi(argv[4]);
    alignas(16) static float dummy[4];
    int refused = 0;
    for (int taps = 1; taps <= 3; taps += 2)
      for (int cin = 16; cin <= max_cin; cin += 16)
        for (int cout = 128; cout <= max_cout; cout += 128)
          if (geoa3_pool_bwd(dummy, dummy, reinterpret_cast<int*>(dummy),
                             reinterpret_cast<int*>(dummy), dummy, dummy, dummy, dummy, 0, 1,
                             cin, cout, taps, dummy, nullptr) != 0) {
            printf("refused cin=%d cout=%d taps=%d\n", cin, cout, taps);
            ++refused;
          }
    printf("refused=%d\n", refused);
    return 0;
  }
  if (argc < 8) return 2;
  const int B = atoi(argv[3]), n = atoi(argv[4]), cin = atoi(argv[5]);
  const int cout = atoi(argv[6]), taps = atoi(argv[7]);
  if (mode == "plan") {
    printf("fwd smem=%zu\n", pool_fwd_smem(cin));
    printf("bwd rows=%d warps=%d cap=%d smem=%zu\n", kBwdRows, kBwdWarps, kBwdCap,
           sizeof(BwdSmem));
    return 0;
  }
  const size_t nx = (size_t)B * n * cin, nw = (size_t)taps * cin * cout;
  const size_t no = (size_t)B * cout;
  float* x = guarded<float>(nx, 0.0f);
  float* w3 = guarded<float>(nw, 0.0f);
  float* w3t = guarded<float>(nw, 0.0f);
  std::vector<float> bias(cout);
  float* g = guarded<float>(no, 0.0f);
  FILE* in = fopen(argv[1], "rb");
  if (!in || fread(x, 4, nx, in) != nx || fread(w3, 4, nw, in) != nw ||
      fread(bias.data(), 4, cout, in) != (size_t)cout || fread(g, 4, no, in) != no)
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
  int err = geoa3_pool_fwd(x, w3, bias.data(), B, n, cin, cout, taps, pooled, cnt, rows,
                           nullptr);
  if (err != 0) {
    printf("geoa3_pool_fwd refused the call: %d\n", err);
    return 1;
  }
  g_bulk_ranges = {{end_of(g, 0), end_of(g, no)},
                   {end_of(cnt, 0), end_of(cnt, no)},
                   {end_of(rows, 0), end_of(rows, no * 4)}};
  err = geoa3_pool_bwd(w3t, g, cnt, rows, x, bias.data(), pooled, w3, B, n, cin, cout, taps,
                       dx, nullptr);
  if (err != 0) {
    printf("geoa3_pool_bwd refused the call: %d\n", err);
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
