"""Sea-ice EVP stress divergence solver (the reference's second workload).

The reference carries ``stress2rhs`` CPU-only as future porting scope
(src/reference.cpp:440-480, docs/refactoring.md:404-462); here it is a
first-class jitted op: the element->node scatter becomes a gather over the
transposed node->element incidence (:func:`ops.stages.stress2rhs`), in any
float dtype.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fesom2_accelerate_tpu.mesh.topology import Mesh
from fesom2_accelerate_tpu.ops import stages
from fesom2_accelerate_tpu.ops.meshdata import build_mesh_data


class Stress2RhsSolver:
    def __init__(self, mesh: Mesh, dtype=jnp.float32):
        self.mesh = mesh
        self.dtype = dtype
        self.md = build_mesh_data(mesh, dtype=dtype)
        # md as argument, not closure (closure-captured arrays become HLO
        # constants)
        self._fn = jax.jit(stages.stress2rhs)

    def __call__(self, elem_area, ice_strength, sigma11, sigma12, sigma22,
                 gradient_sca, metric_factor, inv_areamass, rhs_a, rhs_m):
        args = [
            jnp.asarray(a, dtype=self.dtype)
            for a in (elem_area, ice_strength, sigma11, sigma12, sigma22,
                      gradient_sca, metric_factor, inv_areamass, rhs_a, rhs_m)
        ]
        return self._fn(self.md, *args)
