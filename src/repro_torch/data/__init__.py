"""Workload traces of the paper's evaluation (``workloads``)."""
