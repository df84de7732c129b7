"""circminer-torch: the PyTorch + CUDA port of circminer_tpu.

The JAX package ``circminer_tpu`` is the reference.  This package is the
whole system on torch tensors, with hand-written CUDA kernels for Hopper
(``csrc/``), and owns every module it runs: the host code it shares with
the reference in behaviour (config, FASTA/FASTQ I/O, index build,
annotation, the per-read extension generators, stage 2) is kept here as
copies at the reference's relative paths, and its C++ engines
(``native/*.cpp``) are built from the port's own sources into
``build/circminer_tpu_torch/``.  It imports neither jax nor anything of
``circminer_tpu``.
"""

__version__ = "0.1.0"
