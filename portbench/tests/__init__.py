"""Tests of the benchmark: CPU tests at a tiny size, and card tests marked cuda."""
