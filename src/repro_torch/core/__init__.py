"""The sectored DRAM model: sectors, power and timing, the LSQ lookahead and
sector predictor, the DRAM timing and energy simulator, the evaluated
systems and the area model (host models in numpy)."""
