// Runs csrc/fd_derivs.cu's kernels (float64) on the host, block by block.
//   fd_derivs_host NV N DIR
// reads DIR/{topo.i32, consts.f64, qvu.f64} and writes DIR/{a,Aq,Av,Mi}.f64
// in the kernel's sample-last layouts.
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

static void write(const std::string& path, const std::vector<double>& v) {
  FILE* f = std::fopen(path.c_str(), "wb");
  std::fwrite(v.data(), sizeof(double), v.size(), f);
  std::fclose(f);
}

template <int NV>
static int run(int N, const std::string& dir) {
  auto topo = read<int>(dir + "/topo.i32", 2 * NV);
  auto consts = read<double>(dir + "/consts.f64", 52 * NV + 3);
  auto qvu = read<double>(dir + "/qvu.f64", 3 * NV * size_t(N));
  // outputs NaN until written, so an unwritten entry fails the comparison
  std::vector<double> a(NV * size_t(N), NAN), Aq(NV * NV * size_t(N), NAN), Av(Aq), Mi(Aq);
  std::vector<double> Lf(NV * (NV + 1) / 2 * size_t(N), NAN), kin(KIN_ROWS * NV * size_t(N), NAN);
  // the launches' grids: the primal pass (samples / 64 blocks of 64 threads),
  // then the q and v passes, (samples / 64, NV directions)
  dim3 block, index{0, 0, 0};
  block.x = 64;
  const unsigned blocks = (N + 63) / 64;
  for (index.x = 0; index.x < blocks; ++index.x)
    host_run_block(index, block, [&] {
      fd_primal_kernel<double, NV>(topo.data(), consts.data(), qvu.data(), a.data(), Mi.data(),
                                   Lf.data(), kin.data(), N);
    });
  for (index.y = 0; index.y < unsigned(NV); ++index.y)
    for (index.x = 0; index.x < blocks; ++index.x)
      host_run_block(index, block, [&] {
        fd_q_kernel<double, NV>(topo.data(), consts.data(), qvu.data(), a.data(), Lf.data(),
                                Aq.data(), N);
      });
  for (index.y = 0; index.y < unsigned(NV); ++index.y)
    for (index.x = 0; index.x < blocks; ++index.x)
      host_run_block(index, block, [&] {
        fd_v_kernel<double, NV>(topo.data(), consts.data(), qvu.data(), kin.data(), Lf.data(),
                                Av.data(), N);
      });
  write(dir + "/a.f64", a);
  write(dir + "/Aq.f64", Aq);
  write(dir + "/Av.f64", Av);
  write(dir + "/Mi.f64", Mi);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 4) return 2;
  const int nv = std::atoi(argv[1]), N = std::atoi(argv[2]);
  if (nv == 2) return run<2>(N, argv[3]);
  if (nv == 6) return run<6>(N, argv[3]);
  if (nv == 7) return run<7>(N, argv[3]);
  return 2;
}
