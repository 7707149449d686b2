"""Parses and type-checks the CUDA sources with the host C++ compiler, for
machines without ``nvcc``: each ``dibs_tpu_torch/csrc/*.cu`` goes through
``g++ -std=c++17 -fsyntax-only`` against ``tools/cuda_stub/cuda_runtime.h``
(CUDA's keywords, types and intrinsics as host declarations), with its
launch configurations (``<<<...>>>``) removed, so a kernel launch is
checked as a call. It finds C++ errors such as a template instantiated with
the wrong arguments or a launch whose arguments do not match the kernel;
it cannot find what only ``nvcc`` and ``ptxas`` see (device-only
restrictions, registers, shared memory).

    python tools/cuda_host_check.py            # exit 1 on any error

The stripped copies are written to a temporary directory.
"""
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "dibs_tpu_torch" / "csrc"
STUB = ROOT / "tools" / "cuda_stub"


def check_all():
    """``{source name: g++'s errors, "" where it parsed}`` for every
    ``.cu`` file of ``csrc``."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.h")):
            text = re.sub(r"<<<(?:[^>]|>(?!>>))*>>>", "", path.read_text(),
                          flags=re.S)
            (work / path.name).write_text(text)
        for path in sorted(work.glob("*.cu")):
            proc = subprocess.run(
                ["g++", "-std=c++17", "-fsyntax-only", "-Wno-unknown-pragmas",
                 f"-I{STUB}", "-x", "c++", str(path)],
                capture_output=True, text=True)
            out[path.name] = ("" if proc.returncode == 0 else
                              proc.stderr.replace(str(work), str(CSRC)))
    return out


def main():
    results = check_all()
    for name, errors in results.items():
        print(f"{name}: {'FAILED' if errors else 'ok'}")
        if errors:
            print(errors)
    return 1 if any(results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
