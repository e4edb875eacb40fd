"""Workload generators and the analytic runner of the port."""
