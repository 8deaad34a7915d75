"""Device operators of the port: distances, top-k, the coded IVF scan, beam
search, and the hand-written kernels' wrappers."""
