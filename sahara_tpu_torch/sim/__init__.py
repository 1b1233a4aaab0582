"""Workload generation: read simulator and the benchmark reference."""
