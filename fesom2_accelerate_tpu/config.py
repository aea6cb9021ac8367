"""Runtime configuration for the FCT-ALE solver.

The reference exposes its algorithm switches as bare scalars threaded through
every call (``vlimit`` 1/2/3, ``iter_yn``, ``flux_eps = 1e-16``,
``bignumber = 1e3``, ``dt`` — see reference docs/refactoring.md:32-35 and
src/reference.cpp:14-15).  Here they live in one frozen dataclass that is
hashable, so it can be a static argument to ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class FctAleConfig:
    """Static configuration of one FCT-ALE solve.

    Attributes:
      vlimit: vertical-limiting variant, 1/2/3.  Variant 1 (cluster bounds
        above and below) is the reference's production path
        (src/reference.cpp:297, docs/refactoring.md:77-108); 2 and 3 are the
        more-local variants specified in the Fortran
        (docs/refactoring.md:113-148).
      iter_yn: iterative-FCT flag.  When true, stage c updates ``fct_LO`` and
        swaps the secondary antidiffusive fluxes instead of producing solution
        increments (docs/refactoring.md:227-229,265-290).
      flux_eps: guard epsilon in the Zalesak limiter denominator
        (src/reference.cpp:14).
      bignumber: sentinel used to pad inactive element levels in stage a2 so
        they are transparent to max/min reductions (src/reference.cpp:15,346).
      dt: timestep.
      dtype: floating dtype of the compute path.  float64 matches the
        reference's ``real_type = double`` (include/fesom2-accelerate.h:10)
        and is the correctness gate; float32 (with ``flux_eps`` rescaled to
        1e-7) halves the bytes each step moves.
    """

    vlimit: int = 1
    iter_yn: bool = False
    flux_eps: float = 1e-16
    bignumber: float = 1e3
    dt: float = 1.0
    dtype: Any = jnp.float32

    def __post_init__(self) -> None:
        if self.vlimit not in (1, 2, 3):
            raise ValueError(f"vlimit must be 1, 2 or 3, got {self.vlimit}")

    @property
    def np_dtype(self):
        import numpy as np

        return np.dtype(jnp.dtype(self.dtype).name)
