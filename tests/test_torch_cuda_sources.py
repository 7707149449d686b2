"""Every CUDA source of the port parses and type-checks as C++ on the host
(``tools/cuda_host_check.py``: ``g++ -fsyntax-only`` against a stand-in
for ``<cuda_runtime.h>``, launch configurations removed), so a kernel
instantiated with the wrong template arguments or launched with the wrong
arguments fails here, on a machine without ``nvcc``. Skips where ``g++``
is absent."""
import os
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import cuda_host_check  # noqa: E402

SOURCES = sorted(p.name for p in (ROOT / "dibs_tpu_torch" / "csrc").glob(
    "*.cu"))


@pytest.fixture(scope="module")
def results():
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return cuda_host_check.check_all()


@pytest.mark.parametrize("name", SOURCES)
def test_cuda_source_parses_on_the_host(results, name):
    assert results[name] == "", results[name]


def test_the_check_finds_a_wrong_instantiation(tmp_path, monkeypatch):
    """A kernel template named with one argument too few is an error."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    src = tmp_path / "csrc"
    src.mkdir()
    for path in (ROOT / "dibs_tpu_torch" / "csrc").iterdir():
        text = path.read_text()
        if path.name == "se_matrix.cu":
            text = text.replace("se_matrix_kernel<8, 8, true, false>",
                                "se_matrix_kernel<8, 8, true>")
        (src / path.name).write_text(text)
    monkeypatch.setattr(cuda_host_check, "CSRC", src)
    out = cuda_host_check.check_all()
    assert out["se_matrix.cu"] and not out["gumbel.cu"], out
    assert os.fspath(src) in out["se_matrix.cu"]


def _c_launchers():
    """``{name: parameter count}`` of every ``DIBS_API`` function of the
    sources (preprocessor lines dropped, so a launcher defined under
    several names by ``#if`` gives each)."""
    import re

    out = {}
    for path in (ROOT / "dibs_tpu_torch" / "csrc").glob("*.cu"):
        text = "\n".join(ln for ln in path.read_text().splitlines()
                         if not ln.lstrip().startswith("#"))
        for m in re.finditer(r"((?:DIBS_API\s+[\w\s\*]+?\bdibs_\w+\(\s*)+)"
                             r"([^)]*)\)", text):
            params = m.group(2).strip()
            count = 0 if params in ("", "void") else params.count(",") + 1
            for name in re.findall(r"\b(dibs_\w+)\(", m.group(1)):
                out[name] = count
    return out


def test_ctypes_signatures_match_the_launchers(tmp_path, monkeypatch):
    """``gpu_kernels.build()`` declares as many arguments for each launcher
    as its C definition takes (a launcher that gained a parameter, as the
    particle offset, and a stale declaration fail here, not on the card).
    The build runs with the compiler and ``ctypes`` stubbed."""
    import ctypes
    import types

    from dibs_tpu_torch.ops import gpu_kernels as gk

    def fake_run(cmds):
        for cmd in cmds:
            pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return ""

    lib = types.SimpleNamespace(_name=str(tmp_path / "lib.so"))

    class _Fn:
        argtypes = restype = None

    monkeypatch.setattr(gk, "_lib", None)
    monkeypatch.setattr(gk, "_BUILD", tmp_path)
    monkeypatch.setattr(gk, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(gk, "_run_all", fake_run)
    launchers = _c_launchers()
    for name in launchers:
        setattr(lib, name, _Fn())
    monkeypatch.setattr(ctypes, "CDLL", lambda path: lib)
    gk.build()
    declared = {name: len(fn.argtypes) for name, fn in vars(lib).items()
                if isinstance(fn, _Fn) and fn.argtypes is not None}
    assert "dibs_gumbel_graphs" in declared and \
        "dibs_fused_nonlinear_fleet" in declared
    assert declared == {name: launchers[name] for name in declared}
