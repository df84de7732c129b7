"""Operation and byte counts of the port's hand-written kernels, and the
recorder of their inputs."""
