"""Packaging for dibs-tpu, including the native C++ graph kernel library."""
import subprocess
from pathlib import Path

from setuptools import Command, find_packages, setup
from setuptools.command.build_py import build_py


class BuildNative(Command):
    """Builds dibs_tpu/native/libdibsgraph.so via the Makefile."""

    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        native_dir = Path(__file__).parent / "dibs_tpu" / "native"
        subprocess.run(["make", "-C", str(native_dir)], check=True)


class BuildPyWithNative(build_py):
    def run(self):
        try:
            self.run_command("build_native")
        except Exception as exc:  # pure-python fallback still works
            print(f"warning: native graph library build failed ({exc}); "
                  "falling back to the numpy implementation")
        super().run()


setup(
    name="dibs-tpu",
    version="0.1.0",
    description="TPU-native DiBS: differentiable Bayesian structure learning "
                "with SVGD on JAX/XLA/Pallas",
    packages=find_packages(include=["dibs_tpu", "dibs_tpu.*",
                                    "dibs_tpu_torch", "dibs_tpu_torch.*"]),
    package_data={"dibs_tpu.native": ["*.so", "*.cpp", "Makefile"],
                  "dibs_tpu_torch": ["csrc/*.cu", "csrc/*.h"]},
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.4.30",
        "numpy",
        "optax",
    ],
    extras_require={
        "viz": ["matplotlib"],
        "test": ["pytest", "scikit-learn", "scipy"],
        "checkpoint": ["orbax-checkpoint"],
    },
    cmdclass={"build_native": BuildNative, "build_py": BuildPyWithNative},
)
