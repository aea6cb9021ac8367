"""fesom2_accelerate_tpu — FCT-ALE tracer-advection framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
ESiWACE-S1/fesom2-accelerate CUDA offload library: the 3-D Flux-Corrected
Transport (Zalesak / Löhner FEM-FCT) limiter chain for tracer advection on
unstructured triangular meshes with ALE vertical layers, plus the sea-ice
EVP ``stress2rhs`` workload.  It runs on NVIDIA GPUs (and, for testing, on
the CPU).

Design:

* Dense level-major ``[nl, N]`` arrays: one level row is contiguous over the
  mesh entities (nodes / elements / edges), and the ~48 vertical levels are
  the leading axis.  This replaces the reference's flat strided layout with
  its ``maxLevels + 1`` stride tricks (reference: src/reference.cpp:309,396,
  431).
* Every atomic scatter in the reference (edge->node in
  kernels/fct_ale_b1_horizontal.cu:24-27, element->node in stress2rhs)
  is re-expressed as a deterministic transposed-incidence gather + masked
  reduce, which makes the race class unrepresentable and restores
  exact-match testing.
* Halo exchange (the host MPI ``exchange_nod`` at docs/refactoring.md:200)
  becomes a collective inside ``shard_map`` that node-local compute can
  overlap, mirroring the reference's pre/inter/post-comm phase split
  (src/fesom2-accelerate.cu:258,342,358).
"""

from fesom2_accelerate_tpu.config import FctAleConfig
from fesom2_accelerate_tpu.mesh import Mesh, generate_planar_mesh

__version__ = "0.1.0"

__all__ = [
    "FctAleConfig",
    "Mesh",
    "generate_planar_mesh",
]
