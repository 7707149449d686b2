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
