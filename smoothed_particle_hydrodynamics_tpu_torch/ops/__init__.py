"""Physics, binning, sweeps and step loops on tensors."""
