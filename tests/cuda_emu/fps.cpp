// Runs csrc/fps.cu's C entry on the CPU (through cuda_runtime.h) on clouds
// read from a file, and writes the picks to another:
//
//   fps in.bin out.bin b n m skip has_start
//
// in.bin holds xyz [b, n, 3] float32, then start [b] int32 where has_start
// is 1; out.bin gets idx [b, m] int32. Prints the plan the C entry takes
// (threads, points a thread, coordinates in shared memory, shared memory
// bytes) and exits 1 if the entry refused the call or wrote past idx.
#include "fps_emu.cpp"  // the kernel source, rewritten by the test

#include <cstdio>
#include <vector>

int main(int argc, char** argv) {
  if (argc < 8) return 2;
  const int b = atoi(argv[3]), n = atoi(argv[4]), m = atoi(argv[5]),
            skip = atoi(argv[6]), has_start = atoi(argv[7]);
  std::vector<float> xyz((size_t)b * n * 3);
  std::vector<int> start(b);
  FILE* in = fopen(argv[1], "rb");
  if (!in || fread(xyz.data(), 4, xyz.size(), in) != xyz.size() ||
      (has_start && fread(start.data(), 4, b, in) != (size_t)b))
    return 2;
  fclose(in);

  constexpr int kGuard = 16, kSentinel = -12345;
  std::vector<int> idx((size_t)b * m + kGuard, kSentinel);
  const int err = geoa3_fps(xyz.data(), has_start ? start.data() : nullptr, b,
                            n, m, skip, idx.data(), nullptr);
  const FpsPlan plan = fps_plan(n);
  printf("threads=%d points=%d shared=%d smem=%zu\n", plan.threads,
         plan.points, (int)plan.shared, plan.smem);
  if (err != 0) {
    printf("refused: %d\n", err);
    return 1;
  }
  for (size_t i = (size_t)b * m; i < idx.size(); ++i)
    if (idx[i] != kSentinel) {
      printf("wrote past idx's end at [%zu]\n", i);
      return 1;
    }
  FILE* out = fopen(argv[2], "wb");
  if (!out || fwrite(idx.data(), 4, (size_t)b * m, out) != (size_t)b * m)
    return 2;
  fclose(out);
  return 0;
}
