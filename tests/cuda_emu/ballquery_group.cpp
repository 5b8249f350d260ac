// Runs csrc/ballquery_group.cu's C entries on the CPU (through
// cuda_runtime.h) on inputs read from a file, and writes the outputs to
// another:
//
//   ballquery_group in.bin out.bin b n m ns cf index_only
//
// in.bin holds r2 (one float32), xyz [b, n, 3], centres [b, m, 3], then,
// unless index_only is 1, feats [b, n, cf], dgx [b, m, ns, 3] and dgf
// [b, m, ns, cf] (float32). With index_only 1 it runs geoa3_ball_query and
// writes idx [b, m, ns] int32. Otherwise it runs geoa3_ballquery_group_fwd,
// geoa3_ball_query and geoa3_ballquery_group_bwd (on the forward's idx and
// the cotangents read) and writes idx, gx, gf, the index-only idx, dxyz,
// dcentre and dfeats. The backward's outputs start as NaN, so an entry left
// unwritten shows. Prints the plan the forward takes (cloud in shared memory,
// shared memory bytes) and exits 1 if an entry refused the call or wrote
// past an output.
#include "ballquery_group_emu.cpp"  // the kernel source, rewritten by the test

#include <cstdio>
#include <vector>

namespace {

constexpr int kGuard = 16;

template <class T>
struct Out {
  std::vector<T> v;
  size_t n;
  T sentinel;
  Out(size_t count, T fill, T guard) : v(count + kGuard, fill), n(count), sentinel(guard) {
    for (size_t i = n; i < v.size(); ++i) v[i] = guard;
  }
  T* data() { return v.data(); }
  bool guarded(const char* name) const {
    for (size_t i = n; i < v.size(); ++i)
      if (memcmp(&v[i], &sentinel, sizeof(T)) != 0) {
        printf("wrote past %s's end at [%zu]\n", name, i);
        return false;
      }
    return true;
  }
  void write(FILE* f) const { fwrite(v.data(), sizeof(T), n, f); }
};

bool read(FILE* f, std::vector<float>& v, size_t count) {
  v.resize(count);
  return fread(v.data(), 4, count, f) == count;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 9) return 2;
  const int b = atoi(argv[3]), n = atoi(argv[4]), m = atoi(argv[5]),
            ns = atoi(argv[6]), cf = atoi(argv[7]), index_only = atoi(argv[8]);
  const size_t slots = (size_t)b * m * ns;
  float r2;
  std::vector<float> xyz, centres, feats, dgx, dgf;
  FILE* in = fopen(argv[1], "rb");
  if (!in || fread(&r2, 4, 1, in) != 1 || !read(in, xyz, (size_t)b * n * 3) ||
      !read(in, centres, (size_t)b * m * 3))
    return 2;
  if (!index_only &&
      (!read(in, feats, (size_t)b * n * cf) || !read(in, dgx, slots * 3) ||
       !read(in, dgf, slots * cf)))
    return 2;
  fclose(in);

  const BqPlan plan = bq_plan(n, ns);
  printf("shared=%d smem=%zu\n", (int)plan.shared, plan.smem);
  const float guard = -777.0f;
  Out<int> idx2(slots, -1, -12345);
  if (geoa3_ball_query(xyz.data(), centres.data(), b, n, m, ns, r2,
                       idx2.data(), nullptr) != 0) {
    printf("geoa3_ball_query refused the call\n");
    return 1;
  }
  if (!idx2.guarded("idx (index only)")) return 1;
  FILE* out = fopen(argv[2], "wb");
  if (!out) return 2;
  if (index_only) {
    idx2.write(out);
    fclose(out);
    return 0;
  }
  Out<int> idx(slots, -1, -12345);
  Out<float> gx(slots * 3, NAN, guard), gf(slots * cf, NAN, guard);
  if (geoa3_ballquery_group_fwd(xyz.data(), centres.data(),
                                cf ? feats.data() : nullptr, b, n, m, ns, cf,
                                r2, idx.data(), gx.data(),
                                cf ? gf.data() : nullptr, nullptr) != 0) {
    printf("geoa3_ballquery_group_fwd refused the call\n");
    return 1;
  }
  if (!idx.guarded("idx") || !gx.guarded("gx") || !gf.guarded("gf")) return 1;
  Out<float> dxyz((size_t)b * n * 3, NAN, guard), dcentre((size_t)b * m * 3, NAN, guard),
      dfeats((size_t)b * n * cf, NAN, guard);
  if (geoa3_ballquery_group_bwd(idx.data(), dgx.data(), cf ? dgf.data() : nullptr,
                                b, n, m, ns, cf, dxyz.data(), dcentre.data(),
                                cf ? dfeats.data() : nullptr, nullptr) != 0) {
    printf("geoa3_ballquery_group_bwd refused the call\n");
    return 1;
  }
  if (!dxyz.guarded("dxyz") || !dcentre.guarded("dcentre") ||
      !dfeats.guarded("dfeats"))
    return 1;
  idx.write(out);
  gx.write(out);
  gf.write(out);
  idx2.write(out);
  dxyz.write(out);
  dcentre.write(out);
  dfeats.write(out);
  fclose(out);
  return 0;
}
