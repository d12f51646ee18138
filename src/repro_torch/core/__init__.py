"""Constants of the sectored DRAM model the port's kernels need."""
