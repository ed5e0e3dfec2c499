"""Field-strength tensor F_munu from clover leaves.

Port of the complex path of quda_tpu/ops/fmunu.py (the pair-form branch
waits for a caller): the four plaquette "leaves" around each site in
each of the 6 planes, summed and anti-Hermitian projected.  Used by the
clover term.

Plane ordering: PLANES = [(0,1),(0,2),(0,3),(1,2),(1,3),(2,3)] (mu<nu,
mu,nu in the 0=x..3=t convention).

Output is the HERMITIAN traceless field strength
F_h = -i/8 (Q - Q^dag) - tr/3, so that the clover term
1 + c * sigma_{munu} (x) F_h stays Hermitian.
"""

from __future__ import annotations

import torch

from .shift import shift
from .su3 import dagger, mat_i, mat_mul, trace

PLANES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _leaf_sum(gauge: torch.Tensor, mu: int, nu: int,
              shift_fn=shift) -> torch.Tensor:
    """Sum of the four clover leaves Q_{mu nu}(x) (3,3 per site)."""
    u_mu = gauge[mu]
    u_nu = gauge[nu]

    u_mu_pnu = shift_fn(u_mu, nu, +1)      # U_mu(x+nu)
    u_nu_pmu = shift_fn(u_nu, mu, +1)      # U_nu(x+mu)

    # leaf 1: x -> x+mu -> x+mu+nu -> x+nu -> x
    l1 = mat_mul(mat_mul(u_mu, u_nu_pmu), dagger(mat_mul(u_nu, u_mu_pnu)))

    # leaf 2: x -> x+nu -> x+nu-mu -> x-mu -> x
    u_mu_mmu = shift_fn(u_mu, mu, -1)              # U_mu(x-mu)
    u_nu_mmu = shift_fn(u_nu, mu, -1)              # U_nu(x-mu)
    u_mu_mmu_pnu = shift_fn(u_mu_pnu, mu, -1)      # U_mu(x-mu+nu)
    l2 = mat_mul(mat_mul(u_nu, dagger(u_mu_mmu_pnu)),
                 mat_mul(dagger(u_nu_mmu), u_mu_mmu))

    # leaf 3: x -> x-mu -> x-mu-nu -> x-nu -> x
    u_nu_mnu = shift_fn(u_nu, nu, -1)                        # U_nu(x-nu)
    u_mu_mmu_mnu = shift_fn(u_mu_mmu, nu, -1)                # U_mu(x-mu-nu)
    u_nu_mmu_mnu = shift_fn(u_nu_mmu, nu, -1)                # U_nu(x-mu-nu)
    l3 = mat_mul(mat_mul(dagger(mat_mul(u_nu_mmu_mnu, u_mu_mmu)),
                         u_mu_mmu_mnu), u_nu_mnu)

    # leaf 4: x -> x-nu -> x-nu+mu -> x+mu -> x
    u_mu_mnu = shift_fn(u_mu, nu, -1)              # U_mu(x-nu)
    u_nu_pmu_mnu = shift_fn(u_nu_pmu, nu, -1)      # U_nu(x+mu-nu)
    l4 = mat_mul(mat_mul(dagger(u_nu_mnu), u_mu_mnu),
                 mat_mul(u_nu_pmu_mnu, dagger(u_mu)))

    return l1 + l2 + l3 + l4


def field_strength(gauge: torch.Tensor, shift_fn=shift) -> torch.Tensor:
    """Hermitian traceless F_h[p] for the 6 planes: (6,T,Z,Y,X,3,3),
    from complex links (4,T,Z,Y,X,3,3)."""
    if not gauge.is_complex():
        raise NotImplementedError(
            "field_strength on pair-form links is not ported yet (ROADMAP "
            "A14); pass complex links")
    eye = torch.eye(3, dtype=gauge.dtype, device=gauge.device)
    fs = []
    for mu, nu in PLANES:
        q = _leaf_sum(gauge, mu, nu, shift_fn)
        f = -0.125 * mat_i(q - dagger(q))
        tr = trace(f) / 3.0
        fs.append(f - tr[..., None, None] * eye)
    return torch.stack(fs)
