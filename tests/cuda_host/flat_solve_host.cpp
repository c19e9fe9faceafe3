// Runs csrc/flat_solve.cu's kernel (float64) on the host, block by block, on
// its launch plan, for the flat-lane classes (DYN, COST, E) it instantiates
// below.
//   flat_solve_host DYN COST E DIR [PROGRAM]
// reads DIR/{ints.i32 (the kernel's 10 ints), reals.f64 (its 5 reals),
// x0.f64, us0.f64, scal.f64, consts.f64, mrow.f64} and writes
// DIR/{us,xs,fbk,fbK,stats,mval,mjac}.f64 in the kernel's batch-last layouts,
// in PROGRAM (0 resident, 1 streamed; default -1, the plan's choice), with a
// scratch of the harness's own, and DIR/plan.i32 = {G, LPB, shared-memory
// bytes, program, blocks an SM, blocks, waves}.
//   flat_solve_host plan T C ITEM E B
// prints that plan ("G LPB bytes program blocks_an_SM blocks waves") for a
// class of E rows, C candidates, B lanes and ITEM-byte scalars, or exits 4
// when no lane fits.  Both modes plan for 132 SMs, with the blocks an SM
// holds counted from its shared memory (233,472 bytes, 1 KB reserved a
// block), its 2,048 threads and 32 blocks: the card's registers are not
// known here.
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <string>

#include "cuda_runtime.h"
#include "kernel.inc"

template <typename T>
static std::vector<T> read(const std::string& path, size_t n) {
  std::vector<T> v(n);
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f || std::fread(v.data(), sizeof(T), n, f) != n) std::exit(3);
  std::fclose(f);
  return v;
}

template <typename T>
static void write(const std::string& path, const std::vector<T>& v) {
  FILE* f = std::fopen(path.c_str(), "wb");
  std::fwrite(v.data(), sizeof(T), v.size(), f);
  std::fclose(f);
}

template <typename T>
static std::vector<T> read_all(const std::string& path) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) std::exit(3);
  std::fseek(f, 0, SEEK_END);
  const size_t n = std::ftell(f) / sizeof(T);
  std::fclose(f);
  return read<T>(path, n);
}

constexpr int kSms = 132;

// blocks an H100 SM holds by its shared memory and threads alone
static int host_occupancy(int, int threads, long smem) {
  const long by_smem = 233472 / (smem + 1024), by_threads = 2048 / threads;
  return static_cast<int>(std::min({by_smem, by_threads, 32L}));
}

template <int DYN, int COST, int E>
static int run(const std::string& dir, int program) {
  using P = PendulumClass<double, DYN, COST, E>;
  constexpr int NX = P::NX, M = P::M, EK = E > 0 ? E : 1;
  auto n = read<int>(dir + "/ints.i32", 10);
  auto r = read<double>(dir + "/reals.f64", 5);
  const int T = n[0], B = n[1];
  auto x0 = read<double>(dir + "/x0.f64", NX * size_t(B));
  auto us0 = read<double>(dir + "/us0.f64", size_t(T) * M * B);
  auto scal = read<double>(dir + "/scal.f64", 4 * size_t(B));
  auto consts = read_all<double>(dir + "/consts.f64");
  std::vector<double> mrow(EK, 0.0);  // empty without a constraint
  if (E > 0) mrow = read<double>(dir + "/mrow.f64", E);
  // outputs NaN until written, so an unwritten entry fails the comparison
  std::vector<double> us(size_t(T) * M * B, NAN), xs(size_t(T + 1) * NX * B, NAN), fbk(us),
      fbK(size_t(T) * M * NX * B, NAN), stats(6 * size_t(B), NAN),
      mval(size_t(T) * EK * B, NAN), mjac(size_t(T) * EK * NX * B, NAN);
  SolveArgs<double> a;
  a.x0 = x0.data();
  a.us0 = us0.data();
  a.scal = scal.data();
  a.consts = consts.data();
  a.mrow = mrow.data();
  a.us = us.data();
  a.xs = xs.data();
  a.fbk = fbk.data();
  a.fbK = fbK.data();
  a.stats = stats.data();
  a.mval = mval.data();
  a.mjac = mjac.data();
  a.T = T;
  a.B = B;
  a.n_iters = n[2];
  a.n_ls = n[3];
  a.ta = n[4];
  a.affine = n[5];
  a.primal = n[6];
  a.has_mu_max = n[7];
  a.has_mult_max = n[8];
  a.inner_max = n[9];
  a.threshold = r[0];
  a.w_min = r[1];
  a.mu_factor = r[2];
  a.mu_max = r[3];
  a.mult_max = r[4];
  FlatSolvePlan fp;
  if (!flat_solve_plan(T, NX, M, E, a.n_ls, sizeof(double), B, kSms, program, host_occupancy, &fp))
    return 4;
  if (fp.smem > long(sizeof(host_dynamic_smem))) return 5;
  a.G = fp.G;
  a.LPB = fp.LPB;
  // the streamed program's scratch, NaN until written, with a column for
  // every padded lane
  a.stride = size_t(fp.blocks) * fp.LPB;
  std::vector<double> scratch(
      fp.stream ? size_t(ScratchLayout(T, NX, M, E, a.n_ls).total) * a.stride : 0, NAN);
  a.scratch = scratch.data();
  dim3 block, index{0, 0, 0};
  block.x = a.G * a.LPB;
  for (index.x = 0; index.x < unsigned(fp.blocks); ++index.x) {
    // the shared memory as an uninitialised block finds it
    std::fill(host_dynamic_smem, host_dynamic_smem + fp.smem, static_cast<unsigned char>(0xA5));
    host_run_block(index, block, [&] {
      if (fp.stream)
        flat_solve_kernel<double, P, true>(a);
      else
        flat_solve_kernel<double, P, false>(a);
    });
  }
  write(dir + "/us.f64", us);
  write(dir + "/xs.f64", xs);
  write(dir + "/fbk.f64", fbk);
  write(dir + "/fbK.f64", fbK);
  write(dir + "/stats.f64", stats);
  write(dir + "/mval.f64", mval);
  write(dir + "/mjac.f64", mjac);
  write(dir + "/plan.i32", std::vector<int>{fp.G, fp.LPB, static_cast<int>(fp.smem), fp.stream,
                                            fp.per_sm, fp.blocks, fp.waves});
  return 0;
}

int main(int argc, char** argv) {
  if (argc == 7 && std::string(argv[1]) == "plan") {
    FlatSolvePlan fp;
    if (!flat_solve_plan(std::atoi(argv[2]), 2, 1, std::atoi(argv[5]), std::atoi(argv[3]),
                         std::atoi(argv[4]), std::atoi(argv[6]), kSms, -1, host_occupancy, &fp))
      return 4;
    std::printf("%d %d %ld %d %d %d %d\n", fp.G, fp.LPB, fp.smem, fp.stream, fp.per_sm, fp.blocks,
                fp.waves);
    return 0;
  }
  if (argc != 5 && argc != 6) return 2;
  const int dyn = std::atoi(argv[1]), cost = std::atoi(argv[2]), e = std::atoi(argv[3]);
  const std::string dir = argv[4];
  const int program = argc == 6 ? std::atoi(argv[5]) : -1;
  // the classes the host test holds to the plain version: the headline's and
  // its unconstrained twin, the arrive-at-rest target, the RK4 tracking twin
  if (dyn == 0 && cost == 0 && e == 1) return run<0, 0, 1>(dir, program);
  if (dyn == 0 && cost == 0 && e == 0) return run<0, 0, 0>(dir, program);
  if (dyn == 0 && cost == 0 && e == 2) return run<0, 0, 2>(dir, program);
  if (dyn == 1 && cost == 1 && e == 0) return run<1, 1, 0>(dir, program);
  return 2;
}
