"""PyTorch/CUDA port of the p4mr reproduction, for one NVIDIA H100.

Beside the JAX package ``repro`` (the reference), this package carries the
paper's Map-Reduce data plane — hash-partition mapper, ``all_to_all``
shuffle, segment-reduce reducer — and the §4 S1/S2/S3 in-network
aggregation, the §5 framework (the p4mr IR and DSL in ``core``, the fluent
builder in ``p4mr``, ``verify``, and the pass-based ``compiler`` whose
plans run on the world-dim mesh), and the serving path of the dense
decoder LM (``configs``, ``models``, ``launch``), with hand-written Hopper
kernels in ``kernels``. It imports neither ``jax`` nor anything of
``repro``. Entry points run on the card unless the caller passes
``device="cpu"``.
"""
from repro_torch import compiler, core, data, kernels, mesh, p4mr, shuffle
from repro_torch.mesh import Mesh

__all__ = ["compiler", "core", "data", "kernels", "mesh", "p4mr", "shuffle", "Mesh"]
