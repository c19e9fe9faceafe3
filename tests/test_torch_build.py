"""ddp_tpu_torch/kernels/_build.py without nvcc: the build constants of a
call name its library (one per shape, as a Pallas kernel specialises at trace
time), the same constants always the same library, and a failed build raises
with the compiler's output."""

import shutil

import pytest

from ddp_tpu_torch.kernels import _build
from ddp_tpu_torch.kernels import fd_derivs as fd
from ddp_tpu_torch.kernels import riccati_small as rs


def test_same_constants_same_library_other_constants_another():
    a = _build.library_path(rs.SOURCE, {"N": 4, "M": 2, "E": 2, "SO": 0})
    again = _build.library_path(rs.SOURCE, {"SO": 0, "E": 2, "M": 2, "N": 4})
    assert a == again and a.parent == _build.BUILD_DIR
    assert a.name.startswith("riccati_small-E2-M2-N4-SO0-") and a.suffix == ".so"
    others = [
        _build.library_path(rs.SOURCE, {"N": 4, "M": 2, "E": 2, "SO": 1}),
        _build.library_path(rs.SOURCE, {"N": 6, "M": 3, "E": 3, "SO": 0}),
        _build.library_path(rs.SOURCE, {"N": 4, "M": 2, "E": 1, "SO": 0}),
        _build.library_path(fd.SOURCE, {"NV": 4}),
    ]
    assert len({a, *others}) == 5
    assert _build.library_path("linesearch_flat.cu").name.startswith("linesearch_flat-")


@pytest.mark.parametrize(
    "source,consts,flags",
    [
        (rs.SOURCE, rs.instantiation(4, 2, 2), ["-DDDP_E=2", "-DDDP_M=2", "-DDDP_N=4", "-DDDP_SO=0"]),
        (fd.SOURCE, fd.instantiation(3), ["-DDDP_NV=3"]),
        ("flat_solve.cu", None, []),
    ],
    ids=["riccati", "fd", "flat_solve"],
)
def test_nvcc_command_passes_the_constants_as_defines(monkeypatch, tmp_path, source, consts, flags):
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    out = tmp_path / "lib.so"
    cmd = _build.nvcc_command(source, consts, out)
    assert cmd == ["nvcc", *_build.NVCC_FLAGS, *flags, "-o", str(out), str(_build.CSRC / source)]
    assert "sm_90a" in " ".join(cmd) and "--use_fast_math" not in cmd


def test_the_hash_covers_source_headers_and_defines(monkeypatch, tmp_path):
    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    consts = fd.instantiation(3)
    before = _build.library_path(fd.SOURCE, consts)
    (tmp_path / "fd_chain.cuh").write_text((tmp_path / "fd_chain.cuh").read_text() + "\n")
    after_header = _build.library_path(fd.SOURCE, consts)
    (tmp_path / fd.SOURCE).write_text((tmp_path / fd.SOURCE).read_text() + "\n")
    after_source = _build.library_path(fd.SOURCE, consts)
    assert len({before, after_header, after_source}) == 3


@pytest.mark.parametrize("consts", [{"N": 4.0}, {"N": True}, {"N-1": 2}], ids=["float", "bool", "name"])
def test_constants_are_names_and_integers(consts):
    with pytest.raises(ValueError, match="NAME=int"):
        _build.defines(consts)


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_nvcc", lambda: shutil.which("false"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match=r"nvcc failed on fd_derivs.cu with -DDDP_NV=3"):
        _build.load(fd.SOURCE, fd.instantiation(3))
    assert not any((tmp_path / "_build").iterdir())  # no half-written library
    assert (fd.SOURCE, ("-DDDP_NV=3",)) not in _build.loaded()
