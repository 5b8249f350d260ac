// The inputs and the serial oracle that the grouped-MLP drivers
// (group_mlp_fwd.cpp, group_mlp_bwd.cpp) share. A case is read from the
// command line,
//
//   groups ns cf c1 c2 c3 seed sms shift [tied rows ...]
//
// sms is the SM count the C entries read; shift 1 hands them features one
// float past a 16-byte boundary; the tied rows repeat row 0 of each group.
// The oracle computes each activation as one fmaf chain from 0, k
// ascending, + bias, ReLU (the kernels' contract), then each group's
// maximum and its number of tied rows.
#pragma once

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

struct GroupMlpCase {
  int groups, ns, cf, c0, c1, c2, c3;
  size_t rows;
  std::vector<float> gx, buf, w1, b1, w2, b2, w3, b3;
  float* gf;                  // inside buf, shifted as asked
  std::vector<float> a1, a2, a3;  // [rows][c], the oracle's activations
  std::vector<float> pooled;  // [groups][c3], the oracle's maxima
  std::vector<int> cnt;       // and their tie counts
};

inline void oracle_layer(const float* in, int K, const std::vector<float>& w,
                         const std::vector<float>& b, int C, float* out) {
  for (int c = 0; c < C; ++c) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = std::fmaf(in[k], w[(size_t)k * C + c], acc);
    const float v = acc + b[c];
    out[c] = v > 0.0f ? v : 0.0f;
  }
}

// Reads the case from argv (returns false on too few arguments), makes its
// inputs from the seed, and runs the oracle forward.
inline bool make_case(int argc, char** argv, GroupMlpCase& k,
                      std::mt19937& rng) {
  if (argc < 10) return false;
  k.groups = atoi(argv[1]);
  k.ns = atoi(argv[2]);
  k.cf = atoi(argv[3]);
  k.c1 = atoi(argv[4]);
  k.c2 = atoi(argv[5]);
  k.c3 = atoi(argv[6]);
  rng.seed(atoi(argv[7]));
  g_sms = atoi(argv[8]);
  const int shift = atoi(argv[9]);
  std::vector<int> tied;
  for (int i = 10; i < argc; ++i) tied.push_back(atoi(argv[i]));

  std::normal_distribution<float> nd;
  const int cf = k.cf, c0 = k.c0 = 3 + cf, c1 = k.c1, c2 = k.c2, c3 = k.c3;
  k.rows = (size_t)k.groups * k.ns;
  k.gx.resize(k.rows * 3);
  k.buf.resize(k.rows * cf + 4);
  k.w1.resize((size_t)c0 * c1);
  k.b1.resize(c1);
  k.w2.resize((size_t)c1 * c2);
  k.b2.resize(c2);
  k.w3.resize((size_t)c2 * c3);
  k.b3.resize(c3);
  for (auto& v : k.gx) v = nd(rng);
  k.gf = k.buf.data() + shift;  // vectors are 16-byte aligned
  for (size_t i = 0; i < k.rows * cf; ++i) k.gf[i] = std::max(0.0f, nd(rng));
  auto he = [&](std::vector<float>& w, int cin) {
    for (auto& v : w) v = nd(rng) * std::sqrt(2.0f / cin);
  };
  he(k.w1, c0);
  he(k.w2, c1);
  he(k.w3, c2);
  for (auto* b : {&k.b1, &k.b2, &k.b3})
    for (auto& v : *b) v = 0.1f * nd(rng);
  for (int g = 0; g < k.groups; ++g)
    for (int r : tied) {
      const size_t dst = (size_t)g * k.ns + r, src = (size_t)g * k.ns;
      for (int q = 0; q < 3; ++q) k.gx[dst * 3 + q] = k.gx[src * 3 + q];
      for (int q = 0; q < cf; ++q) k.gf[dst * cf + q] = k.gf[src * cf + q];
    }

  k.a1.resize(k.rows * c1);
  k.a2.resize(k.rows * c2);
  k.a3.resize(k.rows * c3);
  k.pooled.assign((size_t)k.groups * c3, -1.0f);
  k.cnt.assign((size_t)k.groups * c3, 0);
  std::vector<float> in(c0);
  for (size_t row = 0; row < k.rows; ++row) {
    for (int q = 0; q < 3; ++q) in[q] = k.gx[row * 3 + q];
    for (int q = 0; q < cf; ++q) in[3 + q] = k.gf[row * cf + q];
    float* a1 = &k.a1[row * c1];
    float* a2 = &k.a2[row * c2];
    float* a3 = &k.a3[row * c3];
    oracle_layer(in.data(), c0, k.w1, k.b1, c1, a1);
    oracle_layer(a1, c1, k.w2, k.b2, c2, a2);
    oracle_layer(a2, c2, k.w3, k.b3, c3, a3);
    const size_t g = row / k.ns;
    for (int c = 0; c < c3; ++c) {
      float& m = k.pooled[g * c3 + c];
      if (a3[c] > m) {
        m = a3[c];
        k.cnt[g * c3 + c] = 1;
      } else if (a3[c] == m) {
        ++k.cnt[g * c3 + c];
      }
    }
  }
  return true;
}

// Runs the forward C entry; pooled and cnt get kGuard entries past their end
// (NaN and -1), which the kernel must not touch. Returns the entry's error.
constexpr int kGuard = 16;

inline int run_fwd(const GroupMlpCase& k, std::vector<float>& pooled,
                   std::vector<int>& cnt) {
  const size_t n_out = (size_t)k.groups * k.c3;
  pooled.assign(n_out + kGuard, NAN);
  cnt.assign(n_out + kGuard, -1);
  // the most a plan can need: parts of 16 rows
  std::vector<int> scratch(2 * (size_t)k.groups * ((k.ns + 15) / 16) * k.c3 + 1);
  return geoa3_group_mlp_fwd(
      k.gx.data(), k.cf ? k.gf : nullptr, k.w1.data(), k.b1.data(),
      k.w2.data(), k.b2.data(), k.w3.data(), k.b3.data(), k.groups, k.ns,
      k.cf, k.c1, k.c2, k.c3, pooled.data(), cnt.data(),
      k.ns > 16 ? scratch.data() : nullptr, nullptr);
}

// The number of entries of pooled/cnt that differ from the oracle bitwise,
// or -1 after printing where the kernel wrote past their end.
inline long long fwd_differ(const GroupMlpCase& k,
                            const std::vector<float>& pooled,
                            const std::vector<int>& cnt) {
  const size_t n_out = (size_t)k.groups * k.c3;
  for (size_t i = n_out; i < pooled.size(); ++i)
    if (!std::isnan(pooled[i]) || cnt[i] != -1) {
      printf("wrote past the outputs' end at [%zu]\n", i);
      return -1;
    }
  long long bad = 0;
  for (size_t i = 0; i < n_out; ++i)
    if (memcmp(&pooled[i], &k.pooled[i], 4) != 0 || cnt[i] != k.cnt[i]) {
      if (bad < 3)
        printf("[%zu] got (%.9g, %d) want (%.9g, %d)\n", i, pooled[i], cnt[i],
               k.pooled[i], k.cnt[i]);
      ++bad;
    }
  return bad;
}
