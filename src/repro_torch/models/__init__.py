"""Model building blocks: layers, attention, the decode stack."""
