// Runs csrc/group_mlp.cu's forward C entry on the CPU (through
// cuda_runtime.h) and holds pooled and cnt bit-equal to a serial oracle:
// each activation one fmaf chain from 0, k ascending, + bias, ReLU; then
// each group's maximum and its number of tied rows.
//
//   group_mlp_fwd groups ns cf c1 c2 c3 seed sms shift [tied rows ...]
//
// sms is the SM count the C entry reads; shift 1 hands it features one
// float past a 16-byte boundary; the tied rows repeat row 0 of each group.
// Prints the tile plan and the number of entries that differ, and exits 1 if
// any does or if the kernel wrote past the end of pooled or cnt.
#include "group_mlp_emu.cpp"  // the kernel source, rewritten by the test

#include <cstdio>
#include <random>

namespace {

void layer(const std::vector<float>& in, int K, const std::vector<float>& w,
           const std::vector<float>& b, int C, std::vector<float>& out) {
  out.assign(C, 0.0f);
  for (int c = 0; c < C; ++c) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = std::fmaf(in[k], w[(size_t)k * C + c], acc);
    const float v = acc + b[c];
    out[c] = v > 0.0f ? v : 0.0f;
  }
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 10) return 2;
  const int groups = atoi(argv[1]), ns = atoi(argv[2]), cf = atoi(argv[3]);
  const int c1 = atoi(argv[4]), c2 = atoi(argv[5]), c3 = atoi(argv[6]);
  std::mt19937 rng(atoi(argv[7]));
  g_sms = atoi(argv[8]);
  const int shift = atoi(argv[9]);
  std::vector<int> tied;
  for (int i = 10; i < argc; ++i) tied.push_back(atoi(argv[i]));

  std::normal_distribution<float> nd;
  const int c0 = 3 + cf;
  const size_t rows = (size_t)groups * ns;
  std::vector<float> gx(rows * 3), buf(rows * cf + 4), w1((size_t)c0 * c1),
      b1(c1), w2((size_t)c1 * c2), b2(c2), w3((size_t)c2 * c3), b3(c3);
  for (auto& v : gx) v = nd(rng);
  float* gf = buf.data() + shift;  // vectors are 16-byte aligned
  for (size_t i = 0; i < rows * cf; ++i) gf[i] = std::max(0.0f, nd(rng));
  auto he = [&](std::vector<float>& w, int cin) {
    for (auto& v : w) v = nd(rng) * std::sqrt(2.0f / cin);
  };
  he(w1, c0);
  he(w2, c1);
  he(w3, c2);
  for (auto* b : {&b1, &b2, &b3})
    for (auto& v : *b) v = 0.1f * nd(rng);
  for (int g = 0; g < groups; ++g)
    for (int r : tied) {
      const size_t dst = (size_t)g * ns + r, src = (size_t)g * ns;
      for (int k = 0; k < 3; ++k) gx[dst * 3 + k] = gx[src * 3 + k];
      for (int k = 0; k < cf; ++k) gf[dst * cf + k] = gf[src * cf + k];
    }

  // kGuard entries past each output's end, which the kernel must not touch
  constexpr int kGuard = 16;
  const size_t n_out = (size_t)groups * c3;
  std::vector<float> pooled(n_out + kGuard, NAN), want(n_out);
  std::vector<int> cnt(n_out + kGuard, -1), want_cnt(n_out);
  std::vector<int> scratch(2 * (size_t)groups * ((ns + 31) / 32) * c3 + 1);
  const int err = geoa3_group_mlp_fwd(
      gx.data(), cf ? gf : nullptr, w1.data(), b1.data(), w2.data(),
      b2.data(), w3.data(), b3.data(), groups, ns, cf, c1, c2, c3,
      pooled.data(), cnt.data(), ns > 32 ? scratch.data() : nullptr, nullptr);
  if (err) {
    printf("launch refused: %d\n", err);
    return 1;
  }

  std::vector<float> in(c0), a1, a2, a3;
  long long ties = 0;
  for (int g = 0; g < groups; ++g) {
    std::vector<float> m(c3, -1.0f);
    std::vector<int> k(c3, 0);
    for (int r = 0; r < ns; ++r) {
      const size_t row = (size_t)g * ns + r;
      for (int q = 0; q < 3; ++q) in[q] = gx[row * 3 + q];
      for (int q = 0; q < cf; ++q) in[3 + q] = gf[row * cf + q];
      layer(in, c0, w1, b1, c1, a1);
      layer(a1, c1, w2, b2, c2, a2);
      layer(a2, c2, w3, b3, c3, a3);
      for (int c = 0; c < c3; ++c) {
        if (a3[c] > m[c]) {
          m[c] = a3[c];
          k[c] = 1;
        } else if (a3[c] == m[c]) {
          ++k[c];
        }
      }
    }
    for (int c = 0; c < c3; ++c) {
      want[(size_t)g * c3 + c] = m[c];
      want_cnt[(size_t)g * c3 + c] = k[c];
      ties += k[c] > 1;
    }
  }
  long long bad = 0;
  for (size_t i = n_out; i < pooled.size(); ++i)
    if (!std::isnan(pooled[i]) || cnt[i] != -1) {
      printf("wrote past the outputs' end at [%zu]\n", i);
      return 1;
    }
  for (size_t i = 0; i < n_out; ++i)
    if (memcmp(&pooled[i], &want[i], 4) != 0 || cnt[i] != want_cnt[i]) {
      if (bad < 3)
        printf("[%zu] got (%.9g, %d) want (%.9g, %d)\n", i, pooled[i], cnt[i],
               want[i], want_cnt[i]);
      ++bad;
    }
  const Dims d = make_dims(groups, ns, cf, c1, c2, c3);
  const int R = fwd_rows(d);
  const FwdPlan p = fwd_plan(d, R);
  printf("rows=%d slot=%d parts=%d tiles=%lld smem=%zu differ=%lld of %zu tied=%lld\n",
         R, p.P, p.parts, p.tiles, p.smem, bad, n_out, ties);
  return bad != 0;
}
