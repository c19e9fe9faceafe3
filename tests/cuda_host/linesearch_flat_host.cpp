// Runs csrc/linesearch_flat.cu's kernel (float64, the pendulum class) on the
// host, block by block, on its launch plan.
//   linesearch_flat_host E T B C ADVANCE DIR
// reads DIR/{xs,us,k,K,pe,pex,mask,mu,consts}.f64 (batch-major, as the
// wrapper passes them; pe, pex, mask only with E = 1) and writes
// DIR/{xs_out,us_out,step}.f64 and DIR/plan.i32 = {G, LPB, shared-memory
// bytes}.
//   linesearch_flat_host plan T C ITEM
// prints the launch plan "G LPB bytes" of the constrained class at horizon T,
// C candidates and ITEM-byte scalars; exit code 4 when no lane fits.
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

template <int E>
static int run(int T, int B, int C, int advance, const std::string& dir) {
  using P = PendulumEulerTarget<double>;
  constexpr int NX = P::NX, M = P::M;
  const size_t Bs = B;
  auto xs = read<double>(dir + "/xs.f64", Bs * (T + 1) * NX);
  auto us = read<double>(dir + "/us.f64", Bs * T * M);
  auto k = read<double>(dir + "/k.f64", Bs * T * M);
  auto K = read<double>(dir + "/K.f64", Bs * T * M * NX);
  auto mu = read<double>(dir + "/mu.f64", Bs);
  auto consts = read<double>(dir + "/consts.f64", P::N_CONSTS);
  std::vector<double> pe, pex, mask;
  if (E > 0) {
    pe = read<double>(dir + "/pe.f64", Bs * T * E);
    pex = read<double>(dir + "/pex.f64", Bs * T * E * NX);
    mask = read<double>(dir + "/mask.f64", size_t(T) * E);
  }
  // outputs NaN until written, so an unwritten entry fails the comparison
  std::vector<double> xs_out(xs.size(), NAN), us_out(us.size(), NAN), step(Bs, NAN);
  LsArgs<double> a;
  a.xs = xs.data();
  a.us = us.data();
  a.k = k.data();
  a.K = K.data();
  a.pe = pe.data();
  a.pex = pex.data();
  a.mask = mask.data();
  a.mu = mu.data();
  a.xs_out = xs_out.data();
  a.us_out = us_out.data();
  a.step_out = step.data();
  a.T = T;
  a.B = B;
  a.n_cand = C;
  int G;
  long smem = 0;
  if (!linesearch_plan(T, NX, M, E, C, sizeof(double), &G, &a.LPB, &smem)) return 4;
  if (smem > long(sizeof(host_dynamic_smem))) return 5;
  dim3 block, index{0, 0, 0};
  block.x = G * a.LPB;
  const unsigned blocks = (B + a.LPB - 1) / a.LPB;
  for (index.x = 0; index.x < blocks; ++index.x) {
    // the shared memory as an uninitialised block finds it
    std::fill(host_dynamic_smem, host_dynamic_smem + smem, static_cast<unsigned char>(0xA5));
    host_run_block(index, block,
                   [&] { linesearch_flat_kernel<double, P, E>(a, consts.data(), advance); });
  }
  write(dir + "/xs_out.f64", xs_out);
  write(dir + "/us_out.f64", us_out);
  write(dir + "/step.f64", step);
  write(dir + "/plan.i32", std::vector<int>{G, a.LPB, static_cast<int>(smem)});
  return 0;
}

int main(int argc, char** argv) {
  if (argc == 5 && std::string(argv[1]) == "plan") {
    int G, LPB;
    long smem;
    if (!linesearch_plan(std::atoi(argv[2]), 2, 1, 1, std::atoi(argv[3]), std::atoi(argv[4]), &G,
                         &LPB, &smem))
      return 4;
    std::printf("%d %d %ld\n", G, LPB, smem);
    return 0;
  }
  if (argc != 7) return 2;
  const int e = std::atoi(argv[1]), T = std::atoi(argv[2]), B = std::atoi(argv[3]);
  const int C = std::atoi(argv[4]), advance = std::atoi(argv[5]);
  if (e == 1) return run<1>(T, B, C, advance, argv[6]);
  if (e == 0) return run<0>(T, B, C, advance, argv[6]);
  return 2;
}
