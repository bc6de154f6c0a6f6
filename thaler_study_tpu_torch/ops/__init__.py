"""Device programs of the port: the round kernel, the FS prover and its
SHA-256 chain. CUDA sources live in ``csrc/``."""
