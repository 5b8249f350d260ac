// Runs csrc/kappa.cu's mask readers on the CPU (through cuda_runtime.h) on
// inputs read from a file, and writes the output to another:
//
//   kappa entry in.bin out.bin b n k sms shift unstaged [rows_a_stage]
//
// entry is one of
//   frommask   geoa3_kappa_frommask (row 9): kappa [b, n];
//   direct     geoa3_kappa_bwd, direct radius (row 8): grad [b, n, 3];
//   expansion  geoa3_kappa_bwd, expansion radius (row 8): grad [b, n, 3];
//   curv       geoa3_curv_term (row 4): curv [b], then grad [b, n, 3];
//   plan       only prints the stream's plan (in.bin and out.bin unused).
// in.bin holds cloud [b, n, 3] and normal [b, n, 3] (float32), mask
// [b, n, n] (int8), then g [b, n] (direct, expansion) or ref [b, n] (curv),
// float32. sms is what cudaDevAttrMultiProcessorCount reads. The mask is
// placed `shift` bytes past a 64-byte boundary, and a bulk copy may read
// only its bytes and the rest of its first 16-byte line. unstaged = 1 runs
// rows 9 and 8 on the plan that reads the cloud through L2 (the C entries
// take it past the staging limit only), and rows_a_stage > 0 (a power of
// two) on stages of that many rows (the C entries take fewer rows a stage
// than warps only past n = 1024), with a ring of up to kMinStages, after
// zeroing grad itself. The
// outputs start as NaN, so an entry that leaves an element unwritten shows,
// and the 16 guard values past them must stay as they were. Prints the
// stream's plan (rows 9 and 8) and exits 1 if an entry refused the call or
// wrote past an output.
#include "kappa_emu.cpp"  // the kernel source, rewritten by the test

#include <string>

namespace {

constexpr int kGuard = 16;
constexpr float kGuardValue = -777.0f;

float* guarded(size_t count) {
  float* p = new float[count + kGuard];
  for (size_t i = 0; i < count; ++i) p[i] = NAN;
  for (size_t i = count; i < count + kGuard; ++i) p[i] = kGuardValue;
  return p;
}

bool intact(const float* p, size_t count, const char* what) {
  for (size_t i = count; i < count + kGuard; ++i)
    if (memcmp(&p[i], &kGuardValue, 4) != 0) {
      printf("wrote past %s's end at [%zu]\n", what, i);
      return false;
    }
  return true;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 10) return 2;
  const std::string entry = argv[1];
  const int b = atoi(argv[4]), n = atoi(argv[5]), k = atoi(argv[6]);
  const int shift = atoi(argv[8]), unstaged = atoi(argv[9]);
  g_sms = atoi(argv[7]);
  if (entry == "plan") {
    const bool staged = !unstaged && stream_staged(n);
    const StreamPlan p = stream_plan(b, n, staged, g_sms, 2);
    printf("staged=%d S=%d R=%d depth=%d stage=%d per_cloud=%d smem=%zu\n",
           (int)staged, p.S, p.R, p.depth, p.stage, p.per_cloud, p.smem);
    return 0;
  }
  const size_t pts = (size_t)b * n, cells = pts * n;
  std::vector<float> cloud(pts * 3), normal(pts * 3), w(pts);
  char* mask_alloc = static_cast<char*>(
      std::aligned_alloc(64, (cells + shift + 63) / 64 * 64 + 64));
  int8_t* mask = reinterpret_cast<int8_t*>(mask_alloc + shift);
  FILE* in = fopen(argv[2], "rb");
  const bool with_w = entry != "frommask";
  if (!in || fread(cloud.data(), 4, pts * 3, in) != pts * 3 ||
      fread(normal.data(), 4, pts * 3, in) != pts * 3 ||
      fread(mask, 1, cells, in) != cells ||
      (with_w && fread(w.data(), 4, pts, in) != pts))
    return 2;
  fclose(in);
  g_bulk_lo = reinterpret_cast<const char*>(
      reinterpret_cast<uintptr_t>(mask) & ~(uintptr_t)15);
  g_bulk_hi = reinterpret_cast<const char*>(mask) + cells;

  const int rows_a_stage = argc > 10 ? atoi(argv[10]) : 0;
  const bool staged = !unstaged && stream_staged(n);
  const bool custom = unstaged || rows_a_stage > 0;
  StreamPlan p = stream_plan(b, n, staged, g_sms, 2);
  if (rows_a_stage > 0) {  // a power of two
    p.R = min(rows_a_stage, pow2_floor(p.S));
    p.stage = stage_bytes(p.R, n);
    p.depth = min(pow2_ceil((p.S + p.R - 1) / p.R), kMinStages);
    p.smem = stream_smem(n, staged, p.S, p.depth, p.stage);
  }
  if (entry != "curv")
    printf("staged=%d S=%d R=%d depth=%d stage=%d per_cloud=%d smem=%zu\n",
           (int)staged, p.S, p.R, p.depth, p.stage, p.per_cloud, p.smem);
  const size_t out_count = entry == "frommask" ? pts : pts * 3;
  float* out = guarded(out_count);
  float* curv = guarded(b);
  auto run = [&](auto kernel, auto... args) {
    return run_stream(kernel, p, b, nullptr, args...);
  };
  int rc;
  if (entry == "frommask") {
    const float *c = cloud.data(), *nm = normal.data();
    rc = !custom ? geoa3_kappa_frommask(c, nm, mask, b, n, k, out, nullptr)
         : staged ? run(kappa_frommask_stream_kernel<true>, c, nm, mask, n, k, out)
                  : run(kappa_frommask_stream_kernel<false>, c, nm, mask, n, k, out);
  } else if (entry == "direct" || entry == "expansion") {
    const int direct = entry == "direct";
    const float *c = cloud.data(), *nm = normal.data(), *g = w.data();
    if (custom) {
      std::fill(out, out + out_count, 0.0f);
      if (direct)
        rc = staged ? run(kappa_bwd_stream_kernel<Radius::kDirect, true>, c, nm,
                          mask, g, n, k, out)
                    : run(kappa_bwd_stream_kernel<Radius::kDirect, false>, c, nm,
                          mask, g, n, k, out);
      else
        rc = staged ? run(kappa_bwd_stream_kernel<Radius::kExpansion, true>, c, nm,
                          mask, g, n, k, out)
                    : run(kappa_bwd_stream_kernel<Radius::kExpansion, false>, c,
                          nm, mask, g, n, k, out);
    } else {
      rc = geoa3_kappa_bwd(c, nm, mask, g, b, n, k, direct, out, nullptr);
    }
  } else if (entry == "curv") {
    rc = geoa3_curv_term(cloud.data(), normal.data(), w.data(), mask, b, n, k, curv,
                         out, nullptr);
  } else {
    return 2;
  }
  if (rc != 0) {
    printf("%s refused the call (%d)\n", entry.c_str(), rc);
    return 1;
  }
  if (!intact(out, out_count, "the output") || !intact(curv, b, "curv")) return 1;
  FILE* f = fopen(argv[3], "wb");
  if (!f) return 2;
  if (entry == "curv") fwrite(curv, 4, b, f);
  fwrite(out, 4, out_count, f);
  fclose(f);
  return 0;
}
