"""Workload traces of the DRAM simulator."""
