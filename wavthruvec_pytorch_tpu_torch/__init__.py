"""PyTorch + CUDA port of WavThruVec for one NVIDIA H100.

A package of its own beside the JAX reference package
``wavthruvec_pytorch_tpu``; it imports torch, numpy and the standard library
only.  Entry points run on the card unless the caller passes
``device="cpu"``.  See README.md, "PyTorch port".
"""
