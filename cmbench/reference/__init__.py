"""The benchmark's plain reference: a frozen copy of the port's host-only
native path.

Mapping (``native_map.map_pairs``: host C++ seed lookup, chain DP and
finish, ``native/*.cpp``), index build (``index/build.py``), annotation
(``annotation/annotation.py``), FASTA, GTF and FASTQ I/O and the host
stage 2 (``pipeline/circ.py::ProcessCirc.run``, the C++ engine of
``native/circ_kernels.cpp``) as they stood when the benchmark was written.
Later changes to the port do not reach it: it imports nothing of the port,
nothing of the JAX package and no torch, and builds its C++ with g++ into
``cmbench/.cache/native/`` inside the checkout.
"""
