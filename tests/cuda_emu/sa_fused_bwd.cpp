// Runs csrc/sa_fused.cu's forward C entry, then its backward, on the CPU
// (through cuda_runtime.h), on one set-abstraction scale made from a seed:
// clouds xyz [b, n, 3] (normal, sd 0.5), centres that are the clouds' first
// m points (every other one moved 100 away with `far`: empty balls),
// features relu(normal) [b, n, cf] and a He-like folded MLP, and a random
// pooled cotangent g. Holds
//  - idx bit-equal to a serial ball query in the kernels' rounding order;
//  - the projections P and Yc bit-equal to a serial oracle: two fmaf chains
//    from 0, k ascending (x's 3 channels, the features), added; Yc the first
//    alone;
//  - pooled and cnt bit-equal to a serial oracle: a1 = relu((P[idx] - Yc) +
//    b1), each later activation one fmaf chain from 0, k ascending, + bias,
//    ReLU; each ball's maximum and its tie count (the tie sets the
//    backward's recompute must find again);
//  - dP, dYc, dxyz, dcentres and dfeats within 2e-5 of each output's
//    largest entry of the backward taken in float64 through the oracle's
//    float32 ReLU patterns and tie sets: dz3 = g / cnt on the rows whose a3
//    is the ball's maximum and > 0, then through w3 and w2 with the masks
//    a2 > 0 and a1 > 0, scattered into dP by idx, -summed into dYc, and
//    projected back by w1;
//  - the back-projections dxyz, dfeats and dcentres bit-equal to one fmaf
//    chain an output over the kernel's own dP and dYc (c1 steps from 0, k
//    ascending, by W1's rows);
// and fails on a write past the end of an output (the forward's P, Yc, idx,
// pooled and cnt among them).
//
//   sa_fused_bwd b n m ns cf c1 c2 c3 radius seed sms far
//
// Prints the forward's and the backward's tile plans, the projections'
// plans, the largest errors and the entries past the tolerance, and exits
// 1 if any is.
#include "sa_fused_emu.cpp"  // the kernel source, rewritten by the test

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <random>
#include <vector>

namespace {

constexpr int kGuard = 16;
constexpr float kSentinel = 12345.0f;  // past the outputs' end

float chain(const float* x, int K, const float* w, int ldw, int c) {
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) acc = std::fmaf(x[k], w[(size_t)k * ldw + c], acc);
  return acc;
}

float sq3(float x, float y, float z) { return (x * x + y * y) + z * z; }

template <class T>
bool untouched(const std::vector<T>& v, size_t n, const char* name) {
  const T sentinel = (T)kSentinel;
  for (size_t i = n; i < v.size(); ++i)
    if (memcmp(&v[i], &sentinel, sizeof(T)) != 0) {
      printf("wrote past %s's end at [%zu]\n", name, i);
      return false;
    }
  return true;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 13) return 2;
  const int b = atoi(argv[1]), n = atoi(argv[2]), m = atoi(argv[3]),
            ns = atoi(argv[4]), cf = atoi(argv[5]), c1 = atoi(argv[6]),
            c2 = atoi(argv[7]), c3 = atoi(argv[8]);
  const float radius = (float)atof(argv[9]);
  std::mt19937 rng(atoi(argv[10]));
  g_sms = atoi(argv[11]);
  const bool far = atoi(argv[12]) != 0;
  const int c0 = 3 + cf, c0p = (c0 + 3) / 4 * 4;
  const float r2 = radius * radius;
  std::normal_distribution<float> nd;

  std::vector<float> xyz((size_t)b * n * 3), cen((size_t)b * m * 3),
      feats((size_t)b * n * cf + 4);
  for (auto& v : xyz) v = 0.5f * nd(rng);
  for (int bb = 0; bb < b; ++bb)
    for (int j = 0; j < m; ++j)
      for (int q = 0; q < 3; ++q)
        cen[((size_t)bb * m + j) * 3 + q] =
            xyz[((size_t)bb * n + j) * 3 + q] + (far && j % 2 ? 100.0f : 0.0f);
  for (size_t i = 0; i < (size_t)b * n * cf; ++i) feats[i] = std::max(0.0f, nd(rng));
  std::vector<float> w1((size_t)c0 * c1), b1(c1), w2((size_t)c1 * c2), b2(c2),
      w3((size_t)c2 * c3), b3(c3);
  auto he = [&](std::vector<float>& w, int cin) {
    for (auto& v : w) v = nd(rng) * std::sqrt(2.0f / cin);
  };
  he(w1, c0);
  he(w2, c1);
  he(w3, c2);
  for (auto* bias : {&b1, &b2, &b3})
    for (auto& v : *bias) v = 0.1f * nd(rng);

  // the forward C entry, with the split balls' scratch its plan asks for
  const size_t balls = (size_t)b * m, rows = balls * ns;
  const Dims d = make_dims((long long)balls, ns, cf, c1, c2, c3);
  int fR = 0;
  const Plan fp = sa_fwd_plan(d, &fR);
  std::vector<int> scratch(fp.parts > 1 ? 2 * balls * fp.parts * c3 : 0);
  std::vector<float> P((size_t)b * n * c1 + kGuard, kSentinel),
      Yc(balls * c1 + kGuard, kSentinel), pooled(balls * c3 + kGuard, kSentinel);
  std::vector<int> idx(rows + kGuard, (int)kSentinel),
      cnt(balls * c3 + kGuard, (int)kSentinel);
  int err = geoa3_sa_fused_fwd(xyz.data(), cen.data(), cf ? feats.data() : nullptr,
                               w1.data(), b1.data(), w2.data(), b2.data(),
                               w3.data(), b3.data(), b, n, m, ns, cf, c1, c2, c3,
                               r2, P.data(), Yc.data(), idx.data(),
                               pooled.data(), cnt.data(),
                               scratch.empty() ? nullptr : scratch.data(), nullptr);
  if (err) {
    printf("forward refused: %d\n", err);
    return 1;
  }
  if (!untouched(P, (size_t)b * n * c1, "P") || !untouched(Yc, balls * c1, "Yc") ||
      !untouched(idx, rows, "idx") || !untouched(pooled, balls * c3, "pooled") ||
      !untouched(cnt, balls * c3, "cnt"))
    return 1;

  // the serial ball query: d = max((|c|^2 + |x|^2) - 2 c.x, 0) < r2, the
  // first ns hits in index order, an under-full ball repeating its first
  for (size_t g = 0; g < balls; ++g) {
    const float* c = &cen[g * 3];
    const float* x = &xyz[(g / m) * n * 3];
    const float cc = sq3(c[0], c[1], c[2]);
    std::vector<int> hits;
    for (int j = 0; j < n && (int)hits.size() < ns; ++j) {
      const float* p = x + (size_t)j * 3;
      float d = (cc + sq3(p[0], p[1], p[2])) -
                2.0f * ((c[0] * p[0] + c[1] * p[1]) + c[2] * p[2]);
      if ((d > 0.0f ? d : 0.0f) < r2) hits.push_back(j);
    }
    for (int s = 0; s < ns; ++s) {
      const int want = s < (int)hits.size() ? hits[s] : hits.empty() ? 0 : hits[0];
      if (idx[g * ns + s] != want) {
        printf("idx[%zu][%d] got %d want %d\n", g, s, idx[g * ns + s], want);
        return 1;
      }
    }
  }

  // the oracle forward
  std::vector<float> oP((size_t)b * n * c1), oY(balls * c1);
  for (size_t pt = 0; pt < (size_t)b * n; ++pt)
    for (int c = 0; c < c1; ++c) {
      float v = chain(&xyz[pt * 3], 3, w1.data(), c1, c);
      if (cf) v += chain(&feats[pt * cf], cf, w1.data() + (size_t)3 * c1, c1, c);
      oP[pt * c1 + c] = v;
    }
  for (size_t g = 0; g < balls; ++g)
    for (int c = 0; c < c1; ++c) oY[g * c1 + c] = chain(&cen[g * 3], 3, w1.data(), c1, c);
  auto same = [](const char* name, const std::vector<float>& got,
                 const std::vector<float>& want) {
    for (size_t i = 0; i < want.size(); ++i)
      if (memcmp(&got[i], &want[i], 4) != 0) {
        printf("%s[%zu] got %.9g want %.9g: the projection differs from the oracle\n",
               name, i, got[i], want[i]);
        return false;
      }
    return true;
  };
  if (!same("P", P, oP) || !same("Yc", Yc, oY)) return 1;
  std::vector<float> a1(rows * c1), a2(rows * c2), a3(rows * c3);
  std::vector<float> opool(balls * c3, -1.0f);
  std::vector<int> ocnt(balls * c3, 0);
  std::vector<size_t> point(rows);
  for (size_t row = 0; row < rows; ++row) {
    const size_t g = row / ns;
    point[row] = (g / m) * n + idx[row];
    for (int c = 0; c < c1; ++c)
      a1[row * c1 + c] = std::fmax((oP[point[row] * c1 + c] - oY[g * c1 + c]) + b1[c], 0.0f);
    for (int c = 0; c < c2; ++c)
      a2[row * c2 + c] = std::fmax(chain(&a1[row * c1], c1, w2.data(), c2, c) + b2[c], 0.0f);
    for (int c = 0; c < c3; ++c) {
      const float v = std::fmax(chain(&a2[row * c2], c2, w3.data(), c3, c) + b3[c], 0.0f);
      a3[row * c3 + c] = v;
      float& mx = opool[g * c3 + c];
      if (v > mx) {
        mx = v;
        ocnt[g * c3 + c] = 1;
      } else if (v == mx) {
        ++ocnt[g * c3 + c];
      }
    }
  }
  long long differ = 0, ties = 0;
  for (size_t i = 0; i < balls * c3; ++i) {
    ties += ocnt[i] > 1;
    if (memcmp(&pooled[i], &opool[i], 4) != 0 || cnt[i] != ocnt[i]) {
      if (differ < 3)
        printf("pooled[%zu] got (%.9g, %d) want (%.9g, %d)\n", i, pooled[i],
               cnt[i], opool[i], ocnt[i]);
      ++differ;
    }
  }
  if (differ) {
    printf("the forward differs from the oracle (%lld)\n", differ);
    return 1;
  }

  // the backward C entry
  std::vector<float> g(balls * c3);
  for (auto& v : g) v = nd(rng);
  std::vector<float> w1t((size_t)c1 * c0p, 0.0f), w2t((size_t)c2 * c1),
      w3t((size_t)c3 * c2);
  for (int a = 0; a < c0; ++a)
    for (int c = 0; c < c1; ++c) w1t[(size_t)c * c0p + a] = w1[(size_t)a * c1 + c];
  for (int a = 0; a < c1; ++a)
    for (int c = 0; c < c2; ++c) w2t[(size_t)c * c1 + a] = w2[(size_t)a * c2 + c];
  for (int a = 0; a < c2; ++a)
    for (int c = 0; c < c3; ++c) w3t[(size_t)c * c2 + a] = w3[(size_t)a * c3 + c];
  const size_t np = (size_t)b * n;
  std::vector<float> dP(np * c1 + kGuard, kSentinel), dYc(balls * c1 + kGuard, kSentinel),
      dxyz(np * 3 + kGuard, kSentinel), dcen(balls * 3 + kGuard, kSentinel),
      dfeats(np * cf + kGuard, kSentinel);
  std::fill(dP.begin(), dP.begin() + np * c1, 0.0f);  // the caller zeroes dP
  err = geoa3_sa_fused_bwd(P.data(), Yc.data(), idx.data(), b1.data(), w2.data(),
                           b2.data(), w3.data(), b3.data(), w1t.data(), w2t.data(),
                           w3t.data(), pooled.data(), cnt.data(), g.data(), b, n,
                           m, ns, cf, c1, c2, c3, dP.data(), dYc.data(),
                           dxyz.data(), dcen.data(), cf ? dfeats.data() : nullptr,
                           nullptr);
  if (err) {
    printf("backward refused: %d\n", err);
    return 1;
  }
  if (!untouched(dP, np * c1, "dP") || !untouched(dYc, balls * c1, "dYc") ||
      !untouched(dxyz, np * 3, "dxyz") || !untouched(dcen, balls * 3, "dcentres") ||
      !untouched(dfeats, np * cf, "dfeats"))
    return 1;

  // the back-projections: one fmaf chain an output over the kernel's own dP
  // and dYc, c1 steps by W1's rows
  long long unchained = 0;
  auto hold_chain = [&](const char* name, const float* got, const float* dv, size_t nrows,
                        int q0, int nq) {
    for (size_t r = 0; r < nrows; ++r)
      for (int q = 0; q < nq; ++q) {
        const float want = chain(dv + r * c1, c1, w1.data() + (size_t)(q0 + q) * c1, 1, 0);
        if (memcmp(&got[r * nq + q], &want, 4) != 0) {
          if (unchained < 3)
            printf("%s[%zu][%d] got %.9g want the chain's %.9g\n", name, r, q,
                   got[r * nq + q], want);
          ++unchained;
        }
      }
  };
  hold_chain("dxyz", dxyz.data(), dP.data(), np, 0, 3);
  hold_chain("dfeats", dfeats.data(), dP.data(), np, 3, cf);
  hold_chain("dcentres", dcen.data(), dYc.data(), balls, 0, 3);

  // the float64 backward through the oracle's patterns and tie sets
  std::vector<double> wP(np * c1, 0.0), wY(balls * c1, 0.0);
  std::vector<double> dz3(c3), d2(c2);
  long long carried = 0;
  for (size_t row = 0; row < rows; ++row) {
    const size_t gb = row / ns;
    for (int c = 0; c < c3; ++c) {
      const size_t o = gb * c3 + c;
      const bool hit = a3[row * c3 + c] > 0.0f && a3[row * c3 + c] == opool[o];
      dz3[c] = hit ? (double)g[o] / ocnt[o] : 0.0;
      carried += hit;
    }
    for (int j = 0; j < c2; ++j) {
      double s = 0.0;
      if (a2[row * c2 + j] > 0.0f)
        for (int c = 0; c < c3; ++c) s += dz3[c] * w3[(size_t)j * c3 + c];
      d2[j] = s;
    }
    for (int i = 0; i < c1; ++i) {
      double s = 0.0;
      if (a1[row * c1 + i] > 0.0f)
        for (int j = 0; j < c2; ++j) s += d2[j] * w2[(size_t)i * c2 + j];
      wP[point[row] * c1 + i] += s;
      wY[gb * c1 + i] -= s;
    }
  }
  std::vector<double> wx(np * 3), wf(np * cf), wc(balls * 3);
  for (size_t pt = 0; pt < np; ++pt)
    for (int q = 0; q < c0; ++q) {
      double s = 0.0;
      for (int c = 0; c < c1; ++c) s += wP[pt * c1 + c] * w1[(size_t)q * c1 + c];
      if (q < 3)
        wx[pt * 3 + q] = s;
      else
        wf[pt * cf + q - 3] = s;
    }
  for (size_t gb = 0; gb < balls; ++gb)
    for (int q = 0; q < 3; ++q) {
      double s = 0.0;
      for (int c = 0; c < c1; ++c) s += wY[gb * c1 + c] * w1[(size_t)q * c1 + c];
      wc[gb * 3 + q] = s;
    }
  const struct {
    const char* name;
    const float* got;
    const std::vector<double>& want;
  } outs[5] = {{"dP", dP.data(), wP},
               {"dYc", dYc.data(), wY},
               {"dxyz", dxyz.data(), wx},
               {"dcentres", dcen.data(), wc},
               {"dfeats", dfeats.data(), wf}};
  long long bad = 0;
  printf("bwd");
  for (const auto& o : outs) {
    double scale = 0.0, worst = 0.0;
    for (double v : o.want) scale = std::max(scale, std::fabs(v));
    const double tol = 2e-5 * scale;
    for (size_t i = 0; i < o.want.size(); ++i) {
      const double e = std::fabs((double)o.got[i] - o.want[i]);
      worst = std::max(worst, e);
      if (!(e <= tol)) {
        if (bad < 3) printf(" %s[%zu] got %.9g want %.9g;", o.name, i, o.got[i], o.want[i]);
        ++bad;
      }
    }
    printf(" %s_err=%.3e tol=%.3e", o.name, worst, tol);
  }
  int R = 0;
  const Plan p = sa_bwd_plan(d, &R);
  printf("\nrows=%d slot=%d parts=%d tiles=%lld smem=%zu depth=%d sparse=%d bad=%lld "
         "tied=%lld carried=%lld\n",
         R, p.P, p.parts, p.tiles, p.smem, p.bk, p.hits >= 0 ? 1 : 0, bad, ties,
         carried);
  printf("fwd_rows=%d fwd_slot=%d fwd_parts=%d fwd_tiles=%lld fwd_smem=%zu\n", fR,
         fp.P, fp.parts, fp.tiles, fp.smem);
  const ProjPlan pp = project_plan((long long)b * n, (long long)balls, c1),
                 bp = backproject_plan((long long)b * n, (long long)balls, cf);
  printf("proj_quads=%d proj_rows=%d proj_tiles=%lld proj_smem=%zu bproj_quads=%d "
         "bproj_rows=%d bproj_tiles=%lld bproj_smem=%zu unchained=%lld\n",
         pp.quads, pp.rows, pp.tiles, pp.smem, bp.quads, bp.rows, bp.tiles, bp.smem,
         unchained);
  return bad != 0 || unchained != 0;
}
