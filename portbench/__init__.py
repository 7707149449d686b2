"""Benchmark of dibs_tpu_torch on the H100 (see portbench/README.md)."""
