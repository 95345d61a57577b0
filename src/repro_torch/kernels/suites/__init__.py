"""Benchmark suites of KernelCases (importing a module registers its
cases)."""
