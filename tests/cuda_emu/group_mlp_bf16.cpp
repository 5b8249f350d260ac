// Runs csrc/group_mlp_bf16.cu's kernels on the CPU (through cuda_runtime.h)
// on inputs read from a file, and writes their outputs to another:
//
//   group_mlp_bf16 in.bin out.bin groups ns cf c1 c2 c3 npf npb [sms]
//   group_mlp_bf16 plan - groups ns cf c1 c2 c3 [sms]   (prints the plans only)
//
// in.bin holds gx [groups, ns, 3] and gf [groups, ns, cf] (bf16 as uint16),
// then the padded weights as the wrapper makes them: w1 [16 + cf, c1p], b1
// [c1p] (float32), w2 [c1p, c2p], b2, w3 [c2p, c3p], b3, w1t, w2t, w3t (the
// transposes), the streamed kernels' packed weights pf [npf] and pb [npb],
// then the pooled cotangent g [groups, c3] (float32). The program runs
// geoa3_group_mlp_fwd_bf16, then geoa3_group_mlp_bwd_bf16 on its outputs,
// and writes pooled [groups, c3] (float32), cnt (int32), dgx [groups, ns,
// 3] and dgf [groups, ns, cf] (float32). It prints each plan as "fwd|bwd
// rows=R parts=P smem=S depth=D tiles=T grid=B kind=K" (K resident: the
// kernel with resident weights, depth 0, on B persistent blocks for `sms`
// SMs, 1 unless given; wgmma: the streamed one, depth its ring's stages
// (2-4), a block a tile, or the forward's tiles split over up to sms /
// tiles blocks each; tiles: the staged one, depth 32, a block a tile). The
// outputs start as NaN (or -1), so an element
// left unwritten shows, and the 16 guard values past each must stay as they
// were; a bulk copy must read inside one input tensor. Exits 1 if an entry
// refused the call or wrote past an output.
#include "group_mlp_bf16_emu.cpp"  // the kernel source, rewritten by the test

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

template <class T>
bool read(FILE* f, std::vector<T>& v, size_t n) {
  v.resize(n);
  return fread(v.data(), sizeof(T), n, f) == n;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 9) return 2;
  const int groups = atoi(argv[3]), ns = atoi(argv[4]), cf = atoi(argv[5]);
  const int c1 = atoi(argv[6]), c2 = atoi(argv[7]), c3 = atoi(argv[8]);
  const bool plan_only = std::string(argv[1]) == "plan";
  if (!plan_only && argc < 11) return 2;
  const int sms_at = plan_only ? 9 : 11;
  if (argc > sms_at) g_sms = atoi(argv[sms_at]);
  Plan pf, pb;
  if (!plan_of(pf, groups, ns, cf, c1, c2, c3, false) ||
      !plan_of(pb, groups, ns, cf, c1, c2, c3, true)) {
    printf("no plan fits\n");
    return 1;
  }
  for (const bool bwd : {false, true}) {
    const Plan& p = bwd ? pb : pf;
    const Shape& s = p.s;
    if (p.kind == kStreamed) {
      printf("%s rows=%d parts=%d smem=%u depth=%d tiles=%d grid=%d kind=wgmma\n",
             bwd ? "bwd" : "fwd", kWRows, p.w.parts, p.w.smem, p.w.stages, p.w.tiles,
             p.w.tiles * p.w.splits);
      continue;
    }
    printf("%s rows=%d parts=%d smem=%zu depth=%d tiles=%d grid=%u kind=%s\n",
           bwd ? "bwd" : "fwd",
           s.rows, s.parts,
           p.kind == kResident
               ? p.r.smem
               : bwd ? bwd_smem(s.rows, s.c1p, s.c2p, s.c3p) : fwd_smem(s.rows, s.c1p, s.c2p),
           p.kind == kResident ? 0 : KS, s.tiles,
           p.kind == kResident ? res_grid(res_kernel(bwd), s, p.r) : (unsigned)s.tiles,
           p.kind == kResident ? "resident" : "tiles");
  }
  if (plan_only) return 0;

  const int k1 = 16 + cf, c1p = pad16(c1), c2p = pad16(c2), c3p = pad16(c3);
  const size_t rows = (size_t)groups * ns, no = (size_t)groups * c3;
  const size_t npf = atol(argv[9]), npb = atol(argv[10]);
  std::vector<uint16_t> gx, gf, w1, w2, w3, w1t, w2t, w3t, kpf, kpb;
  std::vector<float> b1, b2, b3, g;
  FILE* in = fopen(argv[1], "rb");
  if (!in || !read(in, gx, rows * 3) || !read(in, gf, rows * cf) ||
      !read(in, w1, (size_t)k1 * c1p) || !read(in, b1, c1p) ||
      !read(in, w2, (size_t)c1p * c2p) || !read(in, b2, c2p) ||
      !read(in, w3, (size_t)c2p * c3p) || !read(in, b3, c3p) ||
      !read(in, w1t, (size_t)c1p * k1) || !read(in, w2t, (size_t)c2p * c1p) ||
      !read(in, w3t, (size_t)c3p * c2p) || !read(in, kpf, npf) || !read(in, kpb, npb) ||
      !read(in, g, no))
    return 2;
  fclose(in);
  const void* gfp = cf ? static_cast<const void*>(gf.data()) : nullptr;
  auto allow = [](const auto& v) {
    const char* p = reinterpret_cast<const char*>(v.data());
    g_bulk_ranges.emplace_back(p, p + v.size() * sizeof(v[0]));
  };
  allow(gx);
  allow(gf);
  allow(w1);
  allow(b1);
  allow(w2);
  allow(b2);
  allow(w3);
  allow(b3);
  allow(kpf);
  allow(kpb);
  allow(g);

  float* pooled = guarded<float>(no, NAN);
  int* cnt = guarded<int>(no, -1);
  float* dgx = guarded<float>(rows * 3, NAN);
  float* dgf = guarded<float>(rows * cf, NAN);
  const size_t nscratch = pf.parts() > 1 ? 2 * no * pf.parts() : 0;
  int* scratch = nscratch ? guarded<int>(nscratch, -1) : nullptr;
  g_bulk_ranges.emplace_back(reinterpret_cast<const char*>(pooled),
                             reinterpret_cast<const char*>(pooled + no));
  g_bulk_ranges.emplace_back(reinterpret_cast<const char*>(cnt),
                             reinterpret_cast<const char*>(cnt + no));
  int err = geoa3_group_mlp_fwd_bf16(gx.data(), gfp, w1.data(), b1.data(), w2.data(),
                                     b2.data(), w3.data(), b3.data(), kpf.data(), groups,
                                     ns, cf, c1, c2, c3, pooled, cnt, scratch, nullptr);
  if (err != 0) {
    printf("geoa3_group_mlp_fwd_bf16 refused the call: %d\n", err);
    return 1;
  }
  err = geoa3_group_mlp_bwd_bf16(gx.data(), gfp, w1.data(), b1.data(), w2.data(),
                                 b2.data(), w3.data(), b3.data(), w1t.data(),
                                 w2t.data(), w3t.data(), kpf.data(), kpb.data(), pooled,
                                 cnt, g.data(),
                                 groups, ns, cf, c1, c2, c3, dgx, cf ? dgf : nullptr,
                                 nullptr);
  if (err != 0) {
    printf("geoa3_group_mlp_bwd_bf16 refused the call: %d\n", err);
    return 1;
  }
  if (!intact(pooled, no, "pooled") || !intact(cnt, no, "cnt") ||
      !intact(dgx, rows * 3, "dgx") || !intact(dgf, rows * cf, "dgf") ||
      (scratch && !intact(scratch, nscratch, "scratch")))
    return 1;
  FILE* out = fopen(argv[2], "wb");
  if (!out || fwrite(pooled, 4, no, out) != no || fwrite(cnt, 4, no, out) != no ||
      fwrite(dgx, 4, rows * 3, out) != rows * 3 ||
      fwrite(dgf, 4, rows * cf, out) != rows * cf)
    return 2;
  fclose(out);
  return 0;
}
