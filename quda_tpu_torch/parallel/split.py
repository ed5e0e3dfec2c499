"""Split-grid routing of multi-source solves, as in
quda_tpu/parallel/split.py (single-device part).

The split grid (sources sharded over devices, the gauge field replicated
on each: callMultiSrcQuda's split_key, include/split_grid.h) needs more
than one device and comes with the multi-device port (ROADMAP A15).
Until then ``auto_split_mesh`` finds no usable mesh, and
``multi_src_route`` keeps the JAX package's contract: it returns the
batched or the per-source route, and a forced split raises ValueError.
``split_grid_solve`` waits for A15.
"""

from __future__ import annotations


def auto_split_mesh(n_src: int, devices=None):
    """The device mesh for a split-grid solve of ``n_src`` sources, or
    None when batching on one device is the route.  No mesh is usable
    until the multi-device port (ROADMAP A15), so this returns None."""
    del n_src, devices
    return None


def multi_src_route(n_src: int, *, split_mode: str = "",
                    split_gate: bool = True, batched_gate: bool = True,
                    devices=None):
    """The split / batched / per-source dispatch of
    invert_multi_src_quda: ``(route, mesh, split_gated)``, with ``route``
    in {"split", "batched", "per_source"}, ``mesh`` the split mesh when
    that route serves, and ``split_gated`` True when a usable mesh existed
    but ``split_gate`` (the caller's operator/solver gate) refused it.
    ``split_mode`` is QUDA_TORCH_MULTI_SRC_SPLIT ('1' force, '0' forbid,
    '' auto); forcing split without a usable mesh raises ValueError."""
    mesh = None
    if split_mode != "0":
        mesh = auto_split_mesh(n_src, devices=devices)
        if split_mode == "1" and mesh is None:
            raise ValueError(
                "QUDA_TORCH_MULTI_SRC_SPLIT=1 but no usable src mesh: the "
                "split-grid route needs more than one device and more "
                "than one source, and waits for the multi-device port "
                "(ROADMAP A15)")
    split_gated = mesh is not None and not split_gate
    if split_gated:
        mesh = None
    if mesh is not None:
        return "split", mesh, False
    return ("batched" if batched_gate else "per_source"), None, split_gated
