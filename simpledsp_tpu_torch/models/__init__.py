"""Signal-chain models composed from the ops and kernels."""
