"""The operator API (dslash_quda, mat_quda, mat_dag_mat_quda) of one
family in both packages on the same numpy inputs: shared by the parity
files test_torch_doublet_api.py, test_torch_doublet_clover_api.py and
test_torch_dwf_api.py.

JAX's calls run eagerly or, with ``jit=True``, under ``jax.jit`` (one
compile a call instead of one a primitive: the same functions; cheaper
for the doublets, whose operators share few primitives).  A PC
operator that has no PC hop (JAX's 4d-PC Möbius classes) gives ``None``
for ``dslash``: JAX raises AttributeError there, the port
NotImplementedError.
"""

import jax
import numpy as np
import torch

import quda_tpu_torch as qt
from quda_tpu.interfaces import quda_api as japi
from quda_tpu.interfaces.params import GaugeParam as JGaugeParam
from quda_tpu.interfaces.params import InvertParam as JInvertParam

from tests.torch_inputs import SMALL, gaussian, lattice_shape, rel_err

CAST = {"single": np.complex64, "double": np.complex128}
DWF = ("mobius", "domain-wall-4d", "domain-wall", "mobius-eofa")


def inputs(family, kw, seed):
    """(full-lattice source, half-lattice source) of the family's shape:
    a flavour axis for the doublets, Ls leading for the domain wall."""
    lat = lattice_shape(SMALL)
    half = lat[:3] + (lat[3] // 2,)
    if family in DWF:
        lead, tail = (int(kw["Ls"]),), (4, 3)
    elif family.startswith("ndeg"):
        lead, tail = (), (2, 4, 3)
    else:
        lead, tail = (), (4, 3)
    return (gaussian(lead + lat + tail, seed, dtype=np.complex128),
            gaussian(lead + half + tail, seed + 1, dtype=np.complex128))


def jax_ops(gauge, family, prec, kw, seed, jit=False):
    """JAX's three calls at ``prec``; dslash None where JAX has no PC hop."""
    psi, half = (a.astype(CAST[prec]) for a in inputs(family, kw, seed))
    wrap = jax.jit if jit else (lambda f: f)
    japi.init_quda()
    try:
        japi.load_gauge_quda(gauge.astype(CAST[prec]),
                             JGaugeParam(X=SMALL, cuda_prec=prec))
        p = JInvertParam(dslash_type=family, cuda_prec=prec, **kw)
        try:
            dslash = np.asarray(wrap(
                lambda x: japi.dslash_quda(x, p, 0))(half))
        except AttributeError:
            dslash = None
        return {"dslash": dslash,
                "mat": np.asarray(wrap(lambda x: japi.mat_quda(x, p))(psi)),
                "mdm": np.asarray(wrap(
                    lambda x: japi.mat_dag_mat_quda(x, p))(psi))}
    finally:
        japi.end_quda()


def check_port(gauge, family, prec, kw, seed, want):
    """The port's three calls against JAX's ``want``: 1e-6 complex64,
    1e-12 complex128, dtype and shape; where JAX has no PC hop the port's
    dslash_quda raises NotImplementedError naming D_to."""
    import pytest
    psi, half = (a.astype(CAST[prec]) for a in inputs(family, kw, seed))
    cdt = torch.complex128 if prec == "double" else torch.complex64
    tol = 1e-12 if prec == "double" else 1e-6
    qt.init_quda(device="cpu")
    try:
        qt.load_gauge_quda(gauge.astype(CAST[prec]),
                           qt.GaugeParam(X=SMALL, cuda_prec=prec))
        p = qt.InvertParam(dslash_type=family, cuda_prec=prec, **kw)
        got = {"mat": qt.mat_quda(psi, p),
               "mdm": qt.mat_dag_mat_quda(psi, p)}
        if want["dslash"] is None:
            with pytest.raises(NotImplementedError, match="D_to"):
                qt.dslash_quda(half, p, 0)
        else:
            got["dslash"] = qt.dslash_quda(half, p, 0)
    finally:
        qt.end_quda()
    for name, t in got.items():
        assert t.dtype == cdt, name
        assert tuple(t.shape) == want[name].shape, name
        assert rel_err(t.numpy(), want[name]) < tol, name
