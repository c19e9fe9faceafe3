// Runs csrc/fd_derivs2.cu's kernel (float64) on the host, block by block.
//   fd_derivs2_host NV N DIR
// reads DIR/{topo.i32, consts.f64, qvu.f64} and writes DIR/{a,Aq,Av,Mi,H}.f64
// in the kernel's sample-last layouts.
#include <cstdio>
#include <cstdlib>
#include <string>
#include <type_traits>

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
  std::vector<double> a(NV * size_t(N)), Aq(NV * NV * size_t(N)), Av(Aq.size()), Mi(Aq.size()),
      H(9 * NV * NV * NV * size_t(N), NAN);
  std::vector<double> Lf(NV * (NV + 1) / 2 * size_t(N));
  // the launches' grids: the primal pass (samples / 64 blocks of 64 threads),
  // then a pass per kind of pair, (samples / 64, pairs of the kind)
  dim3 block, index{0, 0, 0};
  block.x = 64;
  const unsigned blocks = (N + 63) / 64;
  for (index.x = 0; index.x < blocks; ++index.x)
    host_run_block(index, block, [&] {
      fd2_primal_kernel<double, NV>(topo.data(), consts.data(), qvu.data(), a.data(), Mi.data(),
                                    Lf.data(), H.data(), N);
    });
  auto pairs = [&](auto kind) {
    constexpr int K = decltype(kind)::value;
    for (index.y = 0; index.y < unsigned(pair_count<K, NV>()); ++index.y)
      for (index.x = 0; index.x < blocks; ++index.x)
        host_run_block(index, block, [&] {
          fd2_pair_kernel<double, NV, K>(topo.data(), consts.data(), qvu.data(), a.data(),
                                         Mi.data(), Lf.data(), Aq.data(), Av.data(), H.data(), N);
        });
  };
  pairs(std::integral_constant<int, QQ>{});
  pairs(std::integral_constant<int, QV>{});
  pairs(std::integral_constant<int, VV>{});
  write(dir + "/a.f64", a);
  write(dir + "/Aq.f64", Aq);
  write(dir + "/Av.f64", Av);
  write(dir + "/Mi.f64", Mi);
  write(dir + "/H.f64", H);
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
