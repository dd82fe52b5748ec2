"""ocaml_hnsw_tpu — an HNSW approximate-nearest-neighbor framework in JAX,
run on an NVIDIA GPU (the package keeps its original name).

A from-scratch rebuild of the capabilities of ``lehy/ocaml-hnsw`` (a pure-OCaml,
single-threaded HNSW library; see SURVEY.md — the reference mount was empty, so the
behavioral spec is the HNSW paper, Malkov & Yashunin arXiv:1603.09320, which the
reference implements).  Design is tensor-first rather than a port:

- the layered pointer graph becomes fixed-degree int32 adjacency tensors in
  device memory,
- the pointer-chasing greedy search becomes batched frontier expansion driven by
  ``lax.while_loop`` — neighbor-id gathers, batched distances, compare-exchange
  beam merges, and beam-only dedup,
- index construction runs as batched parallel insertion rounds, or as a bulk
  kNN-table build when the whole dataset is given at once,
- multi-device scale-out shards the dataset over a ``jax.sharding.Mesh`` with a
  global top-k merge over collectives.
"""

from ocaml_hnsw_tpu.config import HnswConfig

__version__ = "0.1.0"

__all__ = ["HnswConfig", "Index", "BFIndex", "FlatIndex", "__version__"]


def __getattr__(name):
    # Lazy: the API layer pulls in jax; keep `import ocaml_hnsw_tpu` light so the
    # NumPy oracle and harness work without touching the device runtime.
    if name in ("Index", "BFIndex", "FlatIndex"):
        from ocaml_hnsw_tpu import api

        return getattr(api, name)
    raise AttributeError(name)
