"""Clover Hasenbusch-twist operators (mass-splitting preconditioner ops).

Port of quda_tpu/models/hasenbusch.py: the Wilson-clover operator with an
additional i mu gamma5 twist term, used to split the fermion determinant
in Hasenbusch-accelerated HMC,

    M_{+-} = (A +- i mu gamma5) - kappa D,

the twisted-clover operator with the twist a = mu directly (not
2 kappa mu).
"""

from __future__ import annotations

import torch

from ..fields.geometry import LatticeGeometry
from .dirac import MATPC_EVEN_EVEN
from .twisted import DiracTwistedClover, DiracTwistedCloverPC


class DiracCloverHasenbuschTwist(DiracTwistedClover):
    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry,
                 kappa: float, mu: float, csw: float,
                 antiperiodic_t: bool = True):
        super().__init__(gauge, geom, kappa, mu, csw, antiperiodic_t)
        self.a = mu  # direct twist, not 2*kappa*mu


class DiracCloverHasenbuschTwistPC(DiracTwistedCloverPC):
    def __init__(self, gauge: torch.Tensor, geom: LatticeGeometry,
                 kappa: float, mu: float, csw: float,
                 antiperiodic_t: bool = True,
                 matpc: int = MATPC_EVEN_EVEN):
        super().__init__(gauge, geom, kappa, mu, csw, antiperiodic_t, matpc)
        # the twisted diagonal inverse again, with the direct-mu twist
        self.a = mu
        self._set_tw_inv()
