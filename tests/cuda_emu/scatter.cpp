// Runs csrc/scatter.cu's C entries on the CPU (through cuda_runtime.h) on
// inputs read from a file, and writes the output to another:
//
//   scatter entry in.bin out.bin b S n C g shift
//
// entry is one of
//   nc  geoa3_scatter_add_nc: idx [b, S], ct [b, S, C], g sources a warp;
//   3t  geoa3_scatter_add_3t: idx [b, S], ct [b, S, 3] (C == 3), or the o2a
//       backward's [b, 8, S] planes read through their strides (C == 8);
//   3   geoa3_scatter_add_3: idx [b, S / g, g], ct [b, S / g, g, 3].
// in.bin holds idx (int32), then ct (float32). ct is placed `shift` floats
// past a 64-byte boundary (1 makes a float4 read of it unaligned). out.bin
// gets out [b, n, C] (C = 3 for 3t and 3). The output starts as NaN, so an
// entry that leaves an element unwritten shows, and the 16 guard values
// past it must stay as they were. nc prints whether it takes float4 rows
// (vec=). Exits 1 if an entry refused the call or wrote past the output.
#include "scatter_emu.cpp"  // the kernel source, rewritten by the test

#include <cstdio>
#include <string>

namespace {

constexpr int kGuard = 16;
constexpr float kGuardValue = -777.0f;

// `count` floats `shift` floats past a 64-byte boundary
float* aligned_floats(size_t count, int shift) {
  const size_t bytes = ((count + shift) * 4 + 63) / 64 * 64 + 64;
  return static_cast<float*>(std::aligned_alloc(64, bytes)) + shift;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 10) return 2;
  const std::string entry = argv[1];
  const int b = atoi(argv[4]), S = atoi(argv[5]), n = atoi(argv[6]),
            C = atoi(argv[7]), g = atoi(argv[8]), shift = atoi(argv[9]);
  const size_t sources = (size_t)b * S;
  const int oc = entry == "nc" ? C : 3;  // the output's channels
  const size_t ct_count = sources * (entry == "3t" && C == 8 ? 8 : oc);
  std::vector<int> idx(sources);
  float* ct = aligned_floats(ct_count, shift);
  FILE* in = fopen(argv[2], "rb");
  if (!in || fread(idx.data(), 4, sources, in) != sources ||
      fread(ct, 4, ct_count, in) != ct_count)
    return 2;
  fclose(in);

  const size_t out_count = (size_t)b * n * oc;
  float* out = aligned_floats(out_count + kGuard, 0);
  for (size_t i = 0; i < out_count; ++i) out[i] = NAN;
  for (size_t i = out_count; i < out_count + kGuard; ++i) out[i] = kGuardValue;

  int rc;
  if (entry == "nc") {
    printf("vec=%d\n", (int)nc_vec(C, (((uintptr_t)ct | (uintptr_t)out) & 15) == 0));
    rc = geoa3_scatter_add_nc(idx.data(), ct, b, S, n, C, g, out, nullptr);
  } else if (entry == "3t") {
    const long long planes = C == 8;  // [b, 8, S] planes: source stride 1
    rc = geoa3_scatter_add_3t(idx.data(), ct, b, S, n,
                              planes ? 8LL * S : 3LL * S, planes ? 1 : 3,
                              planes ? (long long)S : 1, out, nullptr);
  } else if (entry == "3") {
    rc = geoa3_scatter_add_3(idx.data(), ct, b, S / g, g, n, out, nullptr);
  } else {
    return 2;
  }
  if (rc != 0) {
    printf("%s refused the call (%d)\n", entry.c_str(), rc);
    return 1;
  }
  for (size_t i = out_count; i < out_count + kGuard; ++i)
    if (memcmp(&out[i], &kGuardValue, 4) != 0) {
      printf("wrote past out's end at [%zu]\n", i);
      return 1;
    }
  FILE* f = fopen(argv[3], "wb");
  if (!f) return 2;
  fwrite(out, 4, out_count, f);
  fclose(f);
  return 0;
}
