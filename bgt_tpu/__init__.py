"""bgt_tpu: an accelerator-resident genotype-matrix query engine.

A from-scratch reimplementation of the capabilities of lh3/bgt, built
around packed genotype planes held in device memory:

- on-disk formats (PBF/PBWT+RLE, site-only BCF+CSI/RNI, FMF, SPL) are kept
  byte-compatible with the reference so databases interoperate;
- the device compute path (genotype decode, sample-column subsetting, per-site
  and per-group AC/AN counting, site filters) runs on packed 2-bit genotype
  tiles in device memory via JAX/XLA;
- multi-chip scaling shards the sample-column axis over a jax.sharding.Mesh
  with psum/all_gather collectives (the device-mesh generalization of bgt's
  multi-DB bgtm merge; see reference bgt.c:797-878).
"""

__version__ = "0.1.0"


def open(prefixes):  # noqa: A001
    """Open one or more BGT databases for programmatic queries."""
    from .api import Dataset
    return Dataset(prefixes)
