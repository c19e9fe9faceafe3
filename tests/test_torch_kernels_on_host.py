"""The CUDA sources of kernels #1 (``csrc/riccati_small.cu``), #2
(``csrc/fd_derivs.cu``: primal, q and v passes), #3 (``csrc/fd_derivs2.cu``),
#4 (``csrc/linesearch_flat.cu``) and #5 (``csrc/flat_solve.cu``: both a lane
per group of threads in shared memory, barriers between their phases)
compiled as host C++ and run block by block on the CPU
(``tests/cuda_host/``: one std::thread per GPU thread, barriers for
``__syncthreads``/``__syncwarp``, the dynamic shared memory a static buffer),
in float64, against their plain PyTorch versions on the same numpy-seeded
inputs.

This holds each kernel's own algorithm, thread roles, shared-memory layout
and indexing to the plain version where there is no card; it says nothing of
what nvcc makes of the source, which ``chip_smoke.py`` checks on the card.
Each source is built twice: at -O1, and at -O2 under AddressSanitizer and
UndefinedBehaviorSanitizer, which fail the run on an out-of-bounds access or
undefined behaviour in the kernel's C++.
Bars: the plain versions' own (1e-9 of each array's largest entry, H 1e-8;
the whole solve's opt_lag 1e-9 of the largest |u|), ok, reg_used, μ and reg
exactly equal, H exactly symmetric."""

import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ddp_tpu_torch.convert import problem_from_numpy
from ddp_tpu_torch.kernels import fd_derivs as fd
from ddp_tpu_torch.kernels import fd_derivs2 as fd2
from ddp_tpu_torch.kernels import flat_solve as fs
from ddp_tpu_torch.kernels import linesearch_flat as lsf
from ddp_tpu_torch.kernels.flat_problem import pack_problem
from ddp_tpu_torch.kernels import riccati_small as rs
from ddp_tpu_torch.models import robots
from ddp_tpu_torch.models.rigid_body import build_model
from ddp_tpu_torch.solver import batched as tbatched
from ddp_tpu_torch.solver.solve import SolverParams

from chip_smoke import flat_class_spec
from torch_parity_helpers import random_spd_derivs, t, to_torch_derivs

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "ddp_tpu_torch" / "csrc"
HOST = REPO / "tests" / "cuda_host"
# where every source's host launchers (they use <<<…>>>) and the build
# constants that pick a library's shape begin
CUT = "// ------------------------------------------------------------ launch"
DYNAMIC_SMEM = "extern __shared__ __align__(16) unsigned char smem_raw[];"
FLAGS = {
    "O1": ["-O1"],
    "O2_asan_ubsan": ["-O2", "-fsanitize=address,undefined", "-fno-sanitize-recover=all"],
}
RUN_ENV = {"ASAN_OPTIONS": "detect_leaks=0"}


def run(args):
    subprocess.run(args, check=True, timeout=600, env=dict(os.environ, **RUN_ENV))


# (harness, flags) → the executable: pytest sets a module fixture up again
# when the parameters of the fixtures around it interleave, and a build under
# the sanitizers takes tens of seconds
_BUILT = {}


def build(source, harness, out_dir, flags):
    """The kernels of ``csrc/<source>`` (everything before its launchers) in
    ``tests/cuda_host/<harness>``, compiled with the host's g++ and
    ``FLAGS[flags]``, once a test run."""
    if (harness, flags) in _BUILT:
        return _BUILT[harness, flags]
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the kernels for the CPU")
    src = (CSRC / source).read_text()
    body = src[: src.index(CUT)] + "\n}  // namespace\n"
    if DYNAMIC_SMEM in body:
        body = body.replace(DYNAMIC_SMEM, "unsigned char* const smem_raw = host_dynamic_smem;")
    (out_dir / "kernel.inc").write_text(body)
    exe = out_dir / Path(harness).stem
    subprocess.run(
        [cxx, "-std=c++20", *FLAGS[flags], "-pthread", f"-I{out_dir}", f"-I{HOST}", f"-I{CSRC}",
         "-o", str(exe), str(HOST / harness)],
        check=True, capture_output=True, timeout=600,
    )  # fmt: skip
    _BUILT[harness, flags] = exe
    return exe


def dump(x, path):
    x.detach().contiguous().numpy().tofile(path)


def three_link(device, dtype):
    """A three-revolute arm (axes y, x, y; 0.4 m links, centres of mass
    mid-link, damped): a joint count no robot of the zoo has."""
    joints = [
        dict(type="revolute", parent=i - 1, axis=axis, placement_trans=[0.0, 0.0, 0.4 * (i > 0)],
             mass=1.0 - 0.2 * i, com=[0.0, 0.0, 0.2], inertia=np.diag([0.02, 0.02, 0.005]))
        for i, axis in enumerate(([0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]))
    ]  # fmt: skip
    model = build_model(joints, name="three_link", device=device, dtype=dtype)
    model.damping = torch.full((3,), 0.05, device=device, dtype=dtype)
    return model


MODELS = dict(cartpole=robots.cartpole, panda7=robots.panda7, ur5=robots.ur5, three_link=three_link)


def fd_inputs(name, tmp_path_factory, N):
    """A model, its constants and N numpy-seeded samples, dumped for a host
    harness.  Returns (model, q, v, tau, the directory)."""
    model = MODELS[name](device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(11)
    q = t(rng.uniform(-np.pi, np.pi, (N, model.nv)))
    v, tau = t(rng.normal(size=(N, model.nv))), t(rng.normal(size=(N, model.nv)))
    d = tmp_path_factory.mktemp(name)
    topo, consts = fd._model_constants(model, torch.float64, "cpu")
    dump(topo, d / "topo.i32")
    dump(consts, d / "consts.f64")
    dump(fd.pack_inputs(q, v, tau), d / "qvu.f64")
    return model, q, v, tau, d


def read_fd_outputs(d, nv, N):
    def out(name, rows):
        return torch.from_numpy(np.fromfile(d / f"{name}.f64").reshape(rows, N))

    return fd.unpack_outputs(out("a", nv), out("Aq", nv * nv), out("Av", nv * nv), out("Mi", nv * nv))


# ------------------------------------------------------------- kernel #2

@pytest.fixture(scope="module", params=sorted(FLAGS))
def fd_host(request, tmp_path_factory):
    return build("fd_derivs.cu", "fd_derivs_host.cpp", tmp_path_factory.mktemp("fd"), request.param)


@pytest.fixture(scope="module", params=["cartpole", "panda7", "ur5", "three_link"])
def fd_case(request, fd_host, tmp_path_factory):
    """The host-built primal, q and v passes and the plain version on 40
    numpy-seeded samples (a block of 64 with its ragged edge)."""
    N = 40
    model, q, v, tau, d = fd_inputs(request.param, tmp_path_factory, N)
    run([str(fd_host), str(model.nv), str(N), str(d)])
    return read_fd_outputs(d, model.nv, N), fd.fd_derivs_reference(model, q, v, tau)


@pytest.mark.parametrize("k", range(4), ids=("a", "da_dq", "da_dv", "Minv"))
def test_fd_kernel_matches_plain_version(fd_case, k):
    got, ref = fd_case
    assert bool(torch.isfinite(got[k]).all())  # every entry written
    scale = max(1.0, float(ref[k].abs().max()))
    np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-9 * scale)


# ------------------------------------------------------------- kernel #3


@pytest.fixture(scope="module", params=sorted(FLAGS))
def fd2_host(request, tmp_path_factory):
    return build("fd_derivs2.cu", "fd_derivs2_host.cpp", tmp_path_factory.mktemp("fd2"), request.param)


FD2_OUTPUTS = ("a", "da_dq", "da_dv", "Minv", "H")
FD2_BARS = (1e-9, 1e-9, 1e-9, 1e-9, 1e-8)


@pytest.fixture(scope="module", params=["cartpole", "panda7", "ur5", "three_link"])
def fd2_case(request, fd2_host, tmp_path_factory):
    """The host-built kernel and the plain version on 3 numpy-seeded samples."""
    N = 3
    model, q, v, tau, d = fd_inputs(request.param, tmp_path_factory, N)
    nv = model.nv
    run([str(fd2_host), str(nv), str(N), str(d)])
    H = torch.from_numpy(np.fromfile(d / "H.f64").reshape(9 * nv**3, N))
    got = (*read_fd_outputs(d, nv, N), fd2.unpack_hessian(H, nv))
    return got, fd2.fd_derivs2_reference(model, q, v, tau)


@pytest.mark.parametrize("k", range(5), ids=FD2_OUTPUTS)
def test_fd2_kernel_matches_plain_version(fd2_case, k):
    got, ref = fd2_case
    assert bool(torch.isfinite(got[k]).all())  # every entry written
    scale = max(1.0, float(ref[k].abs().max()))
    np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=FD2_BARS[k] * scale)


def test_fd2_kernel_hessian_structure(fd2_case):
    """Both triangles from one value; exact zeros in the ττ and vτ blocks."""
    H = fd2_case[0][4]
    nv = H.shape[1]
    assert torch.equal(H, H.transpose(-1, -2))
    assert float(H[:, :, 2 * nv :, 2 * nv :].abs().max()) == 0.0
    assert float(H[:, :, nv : 2 * nv, 2 * nv :].abs().max()) == 0.0


# ------------------------------------------------------------- kernel #1


@pytest.fixture(scope="module", params=sorted(FLAGS))
def riccati_host(request, tmp_path_factory):
    return build("riccati_small.cu", "riccati_small_host.cpp", tmp_path_factory.mktemp("ric"), request.param)


def ladder_inputs(B, T, n, m, e, second_order, seed):
    """Random blocks with non-zero rank-3 slabs for ``second_order``; lane 1
    fails at reg and at the first escalation and holds at the second, lane 2
    fails everywhere (μ = 1e3, reg = 0)."""
    fields, pe, pex = random_spd_derivs(B, T, n, m, e, seed)
    if second_order:
        rng = np.random.default_rng(seed + 100)
        for name, rows in (("f", n), ("eq", e)):
            G = 2e-4 * rng.normal(size=(B, T, rows, n + m, n + m))
            G = 0.5 * (G + np.swapaxes(G, -1, -2))
            for key, blk in (("xx", G[..., :n, :n]), ("ux", G[..., n:, :n]), ("uu", G[..., n:, n:])):
                fields[name + key] = np.ascontiguousarray(blk)
    fields["luu"][1] = -5e3 * np.eye(m)
    fields["luu"][2] = -1e9 * np.eye(m)
    return to_torch_derivs(fields), t(pe), t(pex), t(np.full(B, 1e3)), t(np.zeros(B))


@pytest.mark.parametrize(
    "second_order,dims,B,T,L",
    [
        (False, (14, 7, 3), 3, 5, 4),
        (True, (14, 7, 3), 3, 5, 4),
        (False, (12, 6, 6), 3, 4, 1),
        (True, (12, 6, 6), 3, 4, 4),
        (False, (12, 6, 12), 3, 4, 4),
        (False, (2, 1, 1), 37, 6, 1),
        (True, (2, 1, 1), 37, 6, 3),
        (True, (2, 1, 2), 37, 6, 4),
        (True, (4, 2, 2), 37, 6, 4),
        (True, (12, 6, 12), 3, 4, 4),
        (False, (4, 2, 2), 37, 6, 4),
        (False, (6, 3, 3), 37, 5, 4),
        (True, (6, 3, 3), 37, 5, 4),
    ],
    ids=["gn_n14_L4", "so_n14_L4", "gn_n12_L1", "so_n12_L4", "gn_n12_e12_L4", "gn_n2_L1", "so_n2_L3",
         "so_n2_e2_L4", "so_n4_L4", "so_n12_e12_L4", "gn_n4_L4", "gn_n6_L4", "so_n6_L4"],
)
def test_riccati_ladder_kernel_matches_plain_version(riccati_host, tmp_path, second_order, dims, B, T, L):
    """Both programs (a block per lane and a warp per level at n >= 12; a
    thread per lane and level below, ragged over 32-lane blocks) at every
    order they instantiate: ok and reg_used equal, gains within 1e-9, lanes
    no level saved NaN in both."""
    n, m, e = dims
    derivs, pe, pex, mu, reg = ladder_inputs(B, T, n, m, e, second_order, seed=n + L)
    levels = torch.stack(tbatched._reg_levels(mu, reg, L))
    for name, x in rs.kernel_inputs(derivs, pe, pex, mu, levels, second_order).items():
        dump(x, tmp_path / f"{name}.f64")
    args = [int(second_order), n, m, e, T, B, L]
    run([str(riccati_host), *map(str, args), str(tmp_path)])
    k = torch.from_numpy(np.fromfile(tmp_path / "k.f64").reshape(B, T, m))
    K = torch.from_numpy(np.fromfile(tmp_path / "K.f64").reshape(B, T, m, n))
    reg_used = torch.from_numpy(np.fromfile(tmp_path / "reg_used.f64"))
    ok = torch.from_numpy(np.fromfile(tmp_path / "ok.u8", dtype=np.uint8))
    k_r, K_r, ok_r, reg_r = rs.backward_ladder_reference(derivs, pe, pex, mu, levels, second_order)
    assert ok.tolist() == ok_r.to(torch.uint8).tolist()
    assert torch.equal(reg_used, reg_r)
    if L > 2:
        assert ok_r.tolist()[:3] == [True, True, False] and float(reg_r[1]) == 3.2e4
    np.testing.assert_allclose(k.numpy(), k_r.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(K.numpy(), K_r.numpy(), rtol=1e-9, atol=1e-9)


# ------------------------------------------------------------- kernel #5


@pytest.fixture(scope="module", params=sorted(FLAGS))
def flat_solve_host(request, tmp_path_factory):
    return build("flat_solve.cu", "flat_solve_host.cpp", tmp_path_factory.mktemp("fs"), request.param)


FS_T, FS_B = 8, 40
FS_PARAMS = SolverParams(max_iterations=2, threshold=1e-5, mu=1e4, inner_iters_max=1)
# both caps binding: n = 10 lets every lane update its multipliers at once
# (by far more than 20, so the clip cuts them), the next failure's μ·10 is
# cut to 3e4
FS_CAPS = FS_PARAMS._replace(n=10.0, mu_max=3e4, mult_max=20.0)
FS_FIELDS = ("xs", "us", "fb_k", "fb_K", "opt_constr", "opt_lag", "mu", "reg", "w", "n")


@pytest.mark.parametrize(
    "n_ls,case,T,program,capped",
    [(4, "headline", FS_T, None, False), (7, "headline", FS_T, None, False),
     (4, "e0", FS_T, None, False), (4, "state", FS_T, None, False),
     (4, "rk4_tracking", FS_T, None, False), (4, "state", 100, "streamed", False),
     (4, "headline", FS_T, None, True), (4, "headline", FS_T, "streamed", True),
     (7, "headline", FS_T, "streamed", False), (4, "rk4_tracking", FS_T, "streamed", False)],
    ids=["C4", "C7", "C4_e0", "C4_state", "C4_rk4_tracking", "C4_state_T100_streamed", "C4_capped",
         "C4_capped_streamed", "C7_streamed", "C4_rk4_tracking_streamed"],
)  # fmt: skip
def test_flat_solve_kernel_matches_plain_version(flat_solve_host, tmp_path, n_ls, case, T, program,
                                                 capped):
    """The whole solve at B = 40 (two blocks of 32 lanes, the second
    ragged), 2 iterations, lane 3 started at a NaN state: at T = 8 on the
    pendulum headline's class, its unconstrained twin from random controls,
    the arrive-at-rest state target (e = 2) and the RK4 tracking twin (a
    non-zero terminal cost), in the program the launch plan picks there (the
    resident one); the streamed program (its derivatives, multipliers,
    anchors and candidates in a scratch, the sweeps fed through cp.async
    rings) on the state target at T = 100 and at T = 8 on the headline's
    class with 7 candidates and the RK4 twin; and both programs with the μ
    and multiplier caps binding.  Every field of the other lanes within
    1e-9 of its array's largest entry (opt_lag of the largest |u|), μ and
    reg identical; the NaN lane keeps its controls, escalates its reg and
    ends with the plain version's μ and NaN entries."""
    params = FS_CAPS if capped else FS_PARAMS
    problem = problem_from_numpy(flat_class_spec(case, T), device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(4)
    x0 = np.stack([rng.uniform(-np.pi, np.pi, FS_B), np.zeros(FS_B)], axis=1)
    x0[3, 0] = np.nan
    us0 = t(0.5 * rng.normal(size=(FS_B, T, 1))) if case == "e0" else None
    kw = dict(us_init=us0, n_linesearch=n_ls)
    plan = fs.plan_launch(problem, params, t(x0), **kw)
    for name, x in zip(("x0", "us0", "scal", "consts", "mrow"), plan.tensors[:5]):
        dump(x, tmp_path / f"{name}.f64")
    np.asarray(plan.ints, dtype=np.int32).tofile(tmp_path / "ints.i32")
    np.asarray(plan.reals, dtype=np.float64).tofile(tmp_path / "reals.f64")
    flat = plan.flat
    prog = -1 if program is None else fs.PROGRAMS.index(program)
    run([str(flat_solve_host), *map(str, (flat.dynamics, flat.cost, flat.e)), str(tmp_path), str(prog)])
    outs = [
        torch.from_numpy(np.fromfile(tmp_path / f"{n}.f64").reshape(x.shape))
        for n, x in zip(("us", "xs", "fbk", "fbK", "stats", "mval", "mjac"), plan.tensors[5:12])
    ]
    got = fs._result(*outs, T, 1, problem.ne, 2)
    ref = fs.solve_flat_reference(problem, params, t(x0), **kw)
    G, lpb, _, stream = np.fromfile(tmp_path / "plan.i32", dtype=np.int32).tolist()[:4]
    assert G == 8 and lpb == 32 and stream == (program == "streamed")
    if capped:  # both caps bound
        assert float(ref.mu.max()) == FS_CAPS.mu_max
        assert float(ref.mults.jac[torch.arange(FS_B) != 3].abs().max()) == FS_CAPS.mult_max
    lanes = torch.arange(FS_B) != 3
    u_scale = max(1.0, float(ref.us[lanes].abs().max()))
    fields = [(n, getattr(got, n), getattr(ref, n)) for n in FS_FIELDS]
    fields += [("mults." + n, getattr(got.mults, n), getattr(ref.mults, n)) for n in ("val", "jac")]
    for name, g, r in fields:
        assert g.shape == r.shape, name
        if g.numel():
            assert bool(torch.isfinite(g[lanes]).all()), name
            scale = u_scale if name == "opt_lag" else max(1.0, float(r[lanes].abs().max()))
            assert float((g - r)[lanes].abs().max()) <= 1e-9 * scale, name
            assert torch.equal(g[3].isnan(), r[3].isnan()), name  # the NaN lane's NaNs
    assert torch.equal(got.mu, ref.mu) and torch.equal(got.reg, ref.reg)
    assert bool((got.us[3] == (0.0 if us0 is None else us0[3])).all()) and float(got.reg[3]) > 0


def test_flat_solve_plan_places_lanes_at_every_horizon(flat_solve_host):
    """The launch plan at B = 4096 lanes, 4 candidates, on 132 SMs whose
    blocks are counted from shared memory and threads alone (the card also
    counts registers): at T = 32 in float32 the resident program (32 lanes a
    block, one block an SM, one wave, as before); everywhere else the
    streamed one, one wave at T = 32 in float64 (64 lanes an SM; resident: 16
    lanes a block, two waves), at the arrive-at-rest fleet's T = 100, e = 2
    in float32 and float64 (32 lanes an SM; resident in float32: 8 lanes an
    SM, four waves), at the T200 row's T = 200, e = 1 in float32 (32 lanes an
    SM; resident: 4, eight waves); two waves at T = 200 in float64 (16).  A
    lane fits up to T = 4800 in float64 (no plan at T = 5000: the wrapper
    raises ValueError there)."""

    def plan(T, item, e):
        proc = subprocess.run(
            [str(flat_solve_host), "plan", str(T), "4", str(item), str(e), "4096"], capture_output=True,
            text=True, timeout=60, env=dict(os.environ, **RUN_ENV),
        )  # fmt: skip
        if proc.returncode:
            return proc.returncode
        G, lpb, _, stream, per_sm, _, waves = map(int, proc.stdout.split())
        assert G == 8
        return fs.PROGRAMS[stream], per_sm * lpb, waves

    assert plan(32, 4, 1) == ("resident", 32, 1)
    assert plan(32, 8, 1) == ("streamed", 64, 1)
    assert plan(100, 4, 2) == ("streamed", 32, 1)
    assert plan(100, 8, 2) == ("streamed", 32, 1)
    assert plan(200, 4, 1) == ("streamed", 32, 1)
    assert plan(200, 8, 1) == ("streamed", 16, 2)
    assert plan(4800, 8, 1) == ("streamed", 1, 32)
    assert plan(5000, 8, 1) == 4


# ------------------------------------------------------------- kernel #4


@pytest.fixture(scope="module", params=sorted(FLAGS))
def ls_host(request, tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("ls")
    return build("linesearch_flat.cu", "linesearch_flat_host.cpp", out_dir, request.param)


LS_T = 12
# per-lane factors on the feed-forward gains (chip_smoke.py's GAIN_SCALES):
# overlong steps, so that lanes accept different rungs of the ladder
LS_GAINS = (1.5, 2.5, 5.0, 7.0, 11.0, 13.0, 100.0, 1000.0)


def ls_inputs(B, case):
    """A numpy-seeded line-search state at T = 12 of the pendulum headline's
    class (target 2.0 two steps past the horizon), its unconstrained twin
    ("e0") or a class of chip_smoke.py's ``flat_class_spec``: a rollout from random x0s and us,
    random multipliers, μ = 1e3, the gains of a backward sweep at reg = 0
    with lane i's k times LS_GAINS[i % 8], and anti-descent gains (k = 1e3,
    K = 0) on every 5th lane from lane 3.  Returns (problem, (xs, us, k, K,
    mult_val, mult_jac, mu), the anti-descent lanes)."""
    spec = flat_class_spec(case, LS_T)
    if case == "headline":
        spec["target"] = np.array([2.0])
    problem = problem_from_numpy(spec, device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(7)
    x0s, us = t(0.5 * rng.normal(size=(B, 2))), t(0.2 * rng.normal(size=(B, LS_T, 1)))
    xs = problem.rollout(x0s, us)
    e = problem.ne
    val, jac = t(0.3 * rng.normal(size=(B, LS_T, e))), t(0.1 * rng.normal(size=(B, LS_T, e, 2)))
    mu = t(np.full(B, 1e3))
    k, K, ok = tbatched._backward_sweep(problem.derivatives(xs, us), val, jac, mu, t(np.zeros(B)))
    assert bool(ok.all())
    bad = torch.from_numpy(np.arange(B) % 5 == 3)
    k = torch.where(bad[:, None, None], 1e3, k * t(np.resize(LS_GAINS, B))[:, None, None])
    K = torch.where(bad[:, None, None, None], 0.0, K)
    return problem, (xs, us, k, K, val, jac, mu), bad


@pytest.mark.parametrize(
    "n_cand,case,B",
    [(1, "headline", 40), (4, "headline", 70), (7, "headline", 40), (4, "e0", 96),
     (4, "state", 40), (4, "rk4_tracking", 40), (4, "trajectory", 40)],
    ids=["C1", "C4", "C7", "C4_e0", "C4_state", "C4_rk4_tracking", "C4_trajectory"],
)  # fmt: skip
def test_linesearch_kernel_matches_plain_version(ls_host, tmp_path, n_cand, case, B):
    """The kernel at T = 12 against its plain version, over blocks of 32
    lanes with a ragged last one (B = 96 with 4 candidates is three whole
    blocks), lanes accepting different steps and anti-descent lanes rejecting
    all of them, on the pendulum headline's class and its unconstrained twin,
    the arrive-at-rest state target (e = 2), the RK4 tracking twin (a
    non-zero terminal cost) and the trajectory target active at every step
    (its row read at each step's own t): every step equal, xs and us within
    1e-10 of each array's largest entry, the rejected lanes' inputs back bit
    for bit."""
    problem, state, bad = ls_inputs(B, case)
    flat = pack_problem(problem)
    for name, x in zip(("xs", "us", "k", "K", "pe", "pex", "mu"), state):
        dump(x, tmp_path / f"{name}.f64")
    dump(flat.mask, tmp_path / "mask.f64")
    dump(flat.consts, tmp_path / "consts.f64")
    args = [flat.dynamics, flat.cost, flat.e, LS_T, B, n_cand, tmp_path]
    run([str(ls_host), *map(str, args)])
    xs_k = torch.from_numpy(np.fromfile(tmp_path / "xs_out.f64").reshape(B, LS_T + 1, 2))
    us_k = torch.from_numpy(np.fromfile(tmp_path / "us_out.f64").reshape(B, LS_T, 1))
    step_k = torch.from_numpy(np.fromfile(tmp_path / "step.f64"))
    xs_r, us_r, step_r = lsf.linesearch_reference(problem, *state, n_cand)
    assert torch.equal(step_k, step_r)
    rejected = step_r == 0
    assert bool(rejected[bad].all()) and bool((step_r[~bad] > 0).any())
    if n_cand > 1:
        assert len(set(step_r[~bad].tolist())) >= 2  # lanes take different rungs
    for got, ref in ((xs_k, xs_r), (us_k, us_r)):
        assert bool(torch.isfinite(got).all())  # every entry written
        assert float((got - ref).abs().max()) <= 1e-10 * max(1.0, float(ref.abs().max()))
    assert torch.equal(xs_k[rejected], state[0][rejected])
    assert torch.equal(us_k[rejected], state[1][rejected])
    G, lpb, _ = np.fromfile(tmp_path / "plan.i32", dtype=np.int32).tolist()
    assert (G, lpb) == (2 if n_cand == 1 else 8, 32)


def test_linesearch_plan_fits_every_horizon_to_256(ls_host):
    """One lane's row grows with T and C, so the plan of T = 256 at 31
    candidates in float64 (about 209 KB a lane) bounds every smaller case:
    it must fit one block's shared memory, and T = 300 must not (the wrapper
    raises ValueError there).  The headline (T = 32, 4 candidates, float32)
    takes 8 threads a lane and 32 lanes a block."""

    def plan(T, C, item):
        proc = subprocess.run(
            [str(ls_host), "plan", str(T), str(C), str(item)], capture_output=True, text=True,
            timeout=60, env=dict(os.environ, **RUN_ENV),
        )  # fmt: skip
        return proc.returncode, proc.stdout.split()

    rc, (G, lpb, smem) = plan(256, 31, 8)
    assert rc == 0 and (G, lpb) == ("32", "1") and 200_000 < int(smem) <= 232_448
    assert plan(300, 31, 8)[0] == 4
    rc, (G, lpb, _) = plan(32, 4, 4)
    assert rc == 0 and (G, lpb) == ("8", "32")
