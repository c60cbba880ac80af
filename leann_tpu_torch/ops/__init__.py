"""Device operators: exact search, beam search, the fused traversal
kernel and the Vamana builder."""
