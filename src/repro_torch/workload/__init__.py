"""Workload generators of the port."""
