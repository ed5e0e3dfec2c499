"""Spin-projection tables of the Wilson hop.

Port of the table half of quda_tpu/ops/wilson_pallas.py (``_derive_tables``
and ``TABLES``); its canonical-layout kernel ``dslash_pallas`` is not
ported.  The tables are DERIVED from ops/gamma.py and asserted: for
P = 1 - sign*gamma_mu, the half spinor is h_a = psi_a + c_a psi_{j_a}
(a = 0, 1) and the reconstructed rows are out_2 = d_2 h_{k_2},
out_3 = d_3 h_{k_3}.  Both the plain stencil (ops/wilson_packed.py) and
the CUDA kernels (csrc/wilson_hop.cuh, shared by the eo hop and the fused
clover hop, carries them as compile-time constants) use these tables.
"""

from __future__ import annotations

import numpy as np

from . import gamma as g


def _derive_tables():
    tables = {}
    for mu in range(4):
        for sign in (+1, -1):
            P = np.eye(4) - sign * np.asarray(g.GAMMAS[mu])
            entry = {}
            for a in (0, 1):
                row = P[a]
                assert row[a] == 1.0
                nz = [j for j in range(4) if j != a and abs(row[j]) > 1e-12]
                assert len(nz) == 1, (mu, sign, a, row)
                entry[f"j{a}"] = nz[0]
                entry[f"c{a}"] = complex(row[nz[0]])
            for b in (2, 3):
                row = P[b]
                found = False
                for a in (0, 1):
                    ra = P[a]
                    nz_b = np.nonzero(np.abs(row) > 1e-12)[0]
                    nz_a = np.nonzero(np.abs(ra) > 1e-12)[0]
                    if set(nz_b) == set(nz_a):
                        d = row[nz_b[0]] / ra[nz_b[0]]
                        assert np.allclose(row, d * ra), (mu, sign, b)
                        entry[f"k{b}"] = a
                        entry[f"d{b}"] = complex(d)
                        found = True
                        break
                assert found, (mu, sign, b)
            tables[(mu, sign)] = entry
    return tables


TABLES = _derive_tables()
