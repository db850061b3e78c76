"""Readers of the files an orbax ``StandardCheckpointer`` writes, in numpy
and the standard library, so that the port reads the JAX package's
checkpoints without JAX, orbax or tensorstore:

* ``zstd``: zstd frames (RFC 8878), the compression of the store's nodes
  and of the arrays' chunks;
* ``ocdbt``: tensorstore's OCDBT key-value store, read-only;
* ``zarr``: zarr v2 arrays held in that store;
* ``tree``: the checkpoint directory as the nested tree that
  ``ocp.StandardCheckpointer().restore(path)`` returns.
"""
