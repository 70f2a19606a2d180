"""Signal-chain models composed from the ops and kernels: the north-star
chain, the SDR receiver banks and the pulse-Doppler radar."""
