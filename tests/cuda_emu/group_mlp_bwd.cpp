// Runs csrc/group_mlp.cu's forward C entry, then its backward, on the CPU
// (through cuda_runtime.h), on the inputs of group_mlp_case.h and a random
// pooled cotangent g. Holds pooled/cnt bit-equal to the serial oracle and
// dgx/dgf to the backward taken in float64 through the oracle's float32
// ReLU patterns and tie sets (which are the kernel's: its recompute is
// bitwise the oracle's chain): dz3 = g / cnt on the rows whose a3 is the
// group's maximum and > 0, then through w3, w2 and w1 with the masks
// a2 > 0 and a1 > 0. Each of dgx and dgf must lie within 2e-5 of its
// largest entry.
//
//   group_mlp_bwd groups ns cf c1 c2 c3 seed sms shift [tied rows ...]
//
// Prints the tile plan, the largest errors and the entries past the
// tolerance, and exits 1 if any is, or if either kernel wrote past the end
// of its outputs.
#include "group_mlp_emu.cpp"  // the kernel source, rewritten by the test
#include "group_mlp_case.h"

int main(int argc, char** argv) {
  GroupMlpCase k;
  std::mt19937 rng;
  if (!make_case(argc, argv, k, rng)) return 2;
  std::vector<float> pooled;
  std::vector<int> cnt;
  int err = run_fwd(k, pooled, cnt);
  if (err) {
    printf("forward refused: %d\n", err);
    return 1;
  }
  const long long fbad = fwd_differ(k, pooled, cnt);
  if (fbad != 0) {
    printf("the forward differs from the oracle (%lld)\n", fbad);
    return 1;
  }

  const int cf = k.cf, c0 = k.c0, c0p = (c0 + 3) / 4 * 4;
  const int c1 = k.c1, c2 = k.c2, c3 = k.c3;
  std::normal_distribution<float> nd;
  std::vector<float> g((size_t)k.groups * c3);
  for (auto& v : g) v = nd(rng);
  std::vector<float> w1t((size_t)c1 * c0p, 0.0f), w2t((size_t)c2 * c1),
      w3t((size_t)c3 * c2);
  for (int a = 0; a < c0; ++a)
    for (int b = 0; b < c1; ++b) w1t[(size_t)b * c0p + a] = k.w1[(size_t)a * c1 + b];
  for (int a = 0; a < c1; ++a)
    for (int b = 0; b < c2; ++b) w2t[(size_t)b * c1 + a] = k.w2[(size_t)a * c2 + b];
  for (int a = 0; a < c2; ++a)
    for (int b = 0; b < c3; ++b) w3t[(size_t)b * c2 + a] = k.w3[(size_t)a * c3 + b];
  std::vector<float> dgx(k.rows * 3 + kGuard, NAN), dgf(k.rows * cf + kGuard, NAN);
  err = geoa3_group_mlp_bwd(
      k.gx.data(), cf ? k.gf : nullptr, k.w1.data(), k.b1.data(), k.w2.data(),
      k.b2.data(), k.w3.data(), k.b3.data(), w1t.data(), w2t.data(),
      w3t.data(), pooled.data(), cnt.data(), g.data(), k.groups, k.ns, cf, c1,
      c2, c3, dgx.data(), cf ? dgf.data() : nullptr, nullptr);
  if (err) {
    printf("backward refused: %d\n", err);
    return 1;
  }
  for (size_t i = k.rows * 3; i < dgx.size(); ++i)
    if (!std::isnan(dgx[i])) {
      printf("wrote past dgx's end at [%zu]\n", i);
      return 1;
    }
  for (size_t i = k.rows * cf; i < dgf.size(); ++i)
    if (!std::isnan(dgf[i])) {
      printf("wrote past dgf's end at [%zu]\n", i);
      return 1;
    }

  std::vector<double> want_x(k.rows * 3), want_f(k.rows * cf);
  std::vector<double> dz3(c3), d2(c2), d1(c1);
  long long carried = 0;
  for (size_t row = 0; row < k.rows; ++row) {
    const size_t grp = row / k.ns;
    const float* a1 = &k.a1[row * c1];
    const float* a2 = &k.a2[row * c2];
    const float* a3 = &k.a3[row * c3];
    for (int c = 0; c < c3; ++c) {
      const size_t o = grp * c3 + c;
      const bool hit = a3[c] > 0.0f && a3[c] == k.pooled[o];
      dz3[c] = hit ? (double)g[o] / k.cnt[o] : 0.0;
      carried += hit;
    }
    for (int j = 0; j < c2; ++j) {
      double s = 0.0;
      if (a2[j] > 0.0f)
        for (int c = 0; c < c3; ++c) s += dz3[c] * k.w3[(size_t)j * c3 + c];
      d2[j] = s;
    }
    for (int i = 0; i < c1; ++i) {
      double s = 0.0;
      if (a1[i] > 0.0f)
        for (int j = 0; j < c2; ++j) s += d2[j] * k.w2[(size_t)i * c2 + j];
      d1[i] = s;
    }
    for (int q = 0; q < c0; ++q) {
      double s = 0.0;
      for (int i = 0; i < c1; ++i) s += d1[i] * k.w1[(size_t)q * c1 + i];
      if (q < 3)
        want_x[row * 3 + q] = s;
      else
        want_f[row * cf + q - 3] = s;
    }
  }
  long long bad = 0;
  double errs[2] = {0.0, 0.0}, tols[2] = {0.0, 0.0};
  const struct {
    const char* name;
    const float* got;
    const std::vector<double>& want;
  } outs[2] = {{"dgx", dgx.data(), want_x}, {"dgf", dgf.data(), want_f}};
  for (int o = 0; o < 2; ++o) {
    double scale = 0.0;
    for (double v : outs[o].want) scale = std::max(scale, std::fabs(v));
    tols[o] = 2e-5 * scale;
    for (size_t i = 0; i < outs[o].want.size(); ++i) {
      const double e = std::fabs((double)outs[o].got[i] - outs[o].want[i]);
      errs[o] = std::max(errs[o], e);
      if (!(e <= tols[o])) {
        if (bad < 3)
          printf("%s[%zu] got %.9g want %.9g\n", outs[o].name, i,
                 outs[o].got[i], outs[o].want[i]);
        ++bad;
      }
    }
  }
  long long ties = 0;
  for (int c : k.cnt) ties += c > 1;
  const Dims d = make_dims(k.groups, k.ns, cf, c1, c2, c3);
  int R = 0;
  const Plan p = bwd_tile_plan(d, &R);
  printf("rows=%d slot=%d parts=%d tiles=%lld smem=%zu depth=%d kin=%d bad=%lld "
         "dgx_err=%.3e tol=%.3e dgf_err=%.3e tol=%.3e tied=%lld carried=%lld\n",
         R, p.P, p.parts, p.tiles, p.smem, p.bk, p.kin, bad, errs[0], tols[0],
         errs[1], tols[1], ties, carried);
  return bad != 0;
}
