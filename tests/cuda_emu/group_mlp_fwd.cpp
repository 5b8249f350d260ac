// Runs csrc/group_mlp.cu's forward C entry on the CPU (through
// cuda_runtime.h) and holds pooled and cnt bit-equal to the serial oracle
// of group_mlp_case.h.
//
//   group_mlp_fwd groups ns cf c1 c2 c3 seed sms shift [tied rows ...]
//
// Prints the tile plan and the number of entries that differ, and exits 1 if
// any does or if the kernel wrote past the end of pooled or cnt.
#include "group_mlp_emu.cpp"  // the kernel source, rewritten by the test
#include "group_mlp_case.h"

int main(int argc, char** argv) {
  GroupMlpCase k;
  std::mt19937 rng;
  if (!make_case(argc, argv, k, rng)) return 2;
  std::vector<float> pooled;
  std::vector<int> cnt;
  const int err = run_fwd(k, pooled, cnt);
  if (err) {
    printf("launch refused: %d\n", err);
    return 1;
  }
  const long long bad = fwd_differ(k, pooled, cnt);
  if (bad < 0) return 1;
  long long ties = 0;
  for (int c : k.cnt) ties += c > 1;
  const Dims d = make_dims(k.groups, k.ns, k.cf, k.c1, k.c2, k.c3);
  int R = 0;
  const Plan p = fwd_tile_plan(d, &R);
  printf("rows=%d slot=%d parts=%d tiles=%lld smem=%zu depth=%d kin=%d differ=%lld of %zu "
         "tied=%lld\n",
         R, p.P, p.parts, p.tiles, p.smem, p.bk, p.kin, bad, k.pooled.size(), ties);
  return bad != 0;
}
