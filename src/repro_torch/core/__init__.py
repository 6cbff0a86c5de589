"""The paper's sparsity algorithm: distributions, topology, SRigL."""
