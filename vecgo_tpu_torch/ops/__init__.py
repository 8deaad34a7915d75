"""Device operators of the port: distances, top-k, and the fused scan kernel."""
