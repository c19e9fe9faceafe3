// Runs csrc/riccati_small.cu's ladder kernels (float64) on the host, block by
// block, at the shapes main() lists (on the card each shape is a library of
// its own; here one harness holds them all).
//   riccati_small_host SECOND_ORDER N M E T B L DIR
// reads DIR/<field>.f64 for the 18 per-step fields (the six rank-3 ones only
// with SECOND_ORDER; batch-major [B, T, rows]) and mu, levels, lfx, lfxx, and writes DIR/{k, K,
// reg_used}.f64 and DIR/ok.u8 (batch-major).
#include <cstdio>
#include <cstdlib>
#include <string>

#include "cuda_runtime.h"
#include "kernel.inc"

static const char* kNames[N_FIELDS] = {"lx",  "lu",   "lxx",  "lux",  "luu",  "fx",
                                       "fu",  "eq",   "eqx",  "equ",  "pe",   "pex",
                                       "fxx", "fux",  "fuu",  "eqxx", "equx", "equu"};

static std::vector<double> read(const std::string& path, size_t n) {
  std::vector<double> v(n);
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f || std::fread(v.data(), sizeof(double), n, f) != n) std::exit(3);
  std::fclose(f);
  return v;
}

template <typename T>
static void write(const std::string& path, const std::vector<T>& v) {
  FILE* f = std::fopen(path.c_str(), "wb");
  std::fwrite(v.data(), sizeof(T), v.size(), f);
  std::fclose(f);
}

template <int N, int M, int E, bool SO>
static int run(int T, int B, int L, const std::string& dir) {
  std::vector<std::vector<double>> in(N_FIELDS);
  Args<double> a{};
  for (int f = 0; f < (SO ? N_FIELDS : FXX); ++f) {
    in[f] = read(dir + "/" + kNames[f] + ".f64", size_t(B) * T * rows_of<N, M, E>(f));
    a.in[f] = in[f].data();
  }
  auto mu = read(dir + "/mu.f64", B), levels = read(dir + "/levels.f64", size_t(L) * B);
  auto lfx = read(dir + "/lfx.f64", size_t(B) * N), lfxx = read(dir + "/lfxx.f64", size_t(B) * N * N);
  std::vector<double> ks(size_t(L) * B * T * M), Ks(ks.size() * N), k(size_t(B) * T * M, NAN),
      K(k.size() * N, NAN), reg(B, NAN);
  std::vector<unsigned char> ok(B, 2);
  a.mu = mu.data();
  a.levels = levels.data();
  a.lfx = lfx.data();
  a.lfxx = lfxx.data();
  a.ks = ks.data();
  a.Ks = Ks.data();
  a.k_out = k.data();
  a.K_out = K.data();
  a.ok_out = reinterpret_cast<bool*>(ok.data());
  a.reg_out = reg.data();
  a.T = T;
  a.B = B;
  a.L = L;
  if constexpr (N >= 12) {
    dim3 block;
    block.x = 32 * L;
    for (dim3 index{0, 0, 0}; index.x < unsigned(B); ++index.x)
      host_run_block(index, block, [&] { ladder_large_kernel<double, N, M, E, SO>(a); });
  } else {
    dim3 block;
    block.x = 32;
    block.y = L;
    for (dim3 index{0, 0, 0}; index.x < unsigned(B + 31) / 32; ++index.x)
      host_run_block(index, block, [&] { ladder_small_kernel<double, N, M, E, SO>(a); });
  }
  write(dir + "/k.f64", k);
  write(dir + "/K.f64", K);
  write(dir + "/reg_used.f64", reg);
  write(dir + "/ok.u8", ok);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 9) return 2;
  const int so = std::atoi(argv[1]), n = std::atoi(argv[2]), m = std::atoi(argv[3]),
            e = std::atoi(argv[4]), T = std::atoi(argv[5]), B = std::atoi(argv[6]),
            L = std::atoi(argv[7]);
  const std::string dir = argv[8];
  if (so && n == 2 && m == 1 && e == 1) return run<2, 1, 1, true>(T, B, L, dir);
  if (so && n == 4 && m == 2 && e == 2) return run<4, 2, 2, true>(T, B, L, dir);
  if (so && n == 2 && m == 1 && e == 2) return run<2, 1, 2, true>(T, B, L, dir);
  if (so && n == 6 && m == 3 && e == 3) return run<6, 3, 3, true>(T, B, L, dir);
  if (so && n == 12 && m == 6 && e == 6) return run<12, 6, 6, true>(T, B, L, dir);
  if (so && n == 12 && m == 6 && e == 12) return run<12, 6, 12, true>(T, B, L, dir);
  if (so && n == 14 && m == 7 && e == 3) return run<14, 7, 3, true>(T, B, L, dir);
  if (!so && n == 2 && m == 1 && e == 1) return run<2, 1, 1, false>(T, B, L, dir);
  if (!so && n == 4 && m == 2 && e == 2) return run<4, 2, 2, false>(T, B, L, dir);
  if (!so && n == 6 && m == 3 && e == 3) return run<6, 3, 3, false>(T, B, L, dir);
  if (!so && n == 12 && m == 6 && e == 6) return run<12, 6, 6, false>(T, B, L, dir);
  if (!so && n == 12 && m == 6 && e == 12) return run<12, 6, 12, false>(T, B, L, dir);
  if (!so && n == 14 && m == 7 && e == 3) return run<14, 7, 3, false>(T, B, L, dir);
  return 2;
}
