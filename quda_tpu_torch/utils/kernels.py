"""Build, load and dispatch the port's CUDA kernels.

The sources under ``quda_tpu_torch/csrc/`` have a plain C interface.  At
first use on the card, each ``.cu`` is compiled by its own ``nvcc``
process (all started together), and the objects are linked into one
shared library under ``quda_tpu_torch/_build/<hash>/``, keyed by a hash
of the sources, the headers they include and the flags; ``ctypes``
loads it.  Compiling against PyTorch's headers would take minutes per
build instead of seconds.

Every kernel wrapper first calls ``dispatch_device``: CPU tensors take the
plain PyTorch version beside the kernel, CUDA tensors launch the kernel
(or raise), and anything else raises.  There is no fallback from a
failed build or launch to the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("wilson_eo.cu", "clover_eo.cu", "wilson_eo_mrhs.cu",
           "clover_eo_mrhs.cu", "blas_fused.cu", "staggered_eo.cu",
           "staggered_eo_mrhs.cu", "wilson_full.cu", "coarse.cu",
           "staggered_full.cu", "wilson_eo_there.cu", "wilson_eo_int8.cu",
           "wilson_eo_fold.cu", "wilson_canonical.cu", "clover_full.cu",
           "halo.cu")
# headers the sources include: part of the build's hash, never compiled alone
HEADERS = ("wilson_hop.cuh", "staggered_hop.cuh", "clover_epilogue.cuh",
           "async_copy.cuh", "mrhs_tile.cuh")
LIB_NAME = "libquda_tpu_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C entry points: name -> argtypes (every entry returns cudaGetLastError())
SIGNATURES = {
    # out, psi, u_here, u_bw, T, Z, Y, Xh, parity, store_bf16, out_bf16,
    # rows, tb_sign, stream
    "qtt_wilson_eo": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _P),
    # out, psi, u_here, u_bw, blk, xc, T, Z, Y, Xh, parity, store_bf16,
    # rows, tb_sign, diag_hop, coeff, with_blk, twist, tw_c, tw_scale,
    # stream
    "qtt_clover_eo": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _F, _I, _I, _F, _F, _P),
    # out, psi, u_here, u_bw, T, Z, Y, Xh, parity, rows, tb_sign, nrhs, nb,
    # stream
    "qtt_wilson_eo_mrhs": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P),
    # T, Z, Y, Xh, rows, nb, info[6] (registers, shared bytes, blocks an SM,
    # threads, tiles a plane, blocks)
    "qtt_wilson_eo_mrhs_info": (_I, _I, _I, _I, _I, _I, _P),
    # out, psi, u_here, u_bw, blk, xc, T, Z, Y, Xh, parity, rows, tb_sign,
    # diag_hop, coeff, with_blk, twist, tw_c, tw_scale, nrhs, stream
    "qtt_clover_eo_mrhs": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I, _F, _I, _I, _F, _F, _I, _P),
    # T, Z, Y, Xh, rows, diag_hop, with_blk, twist, info
    "qtt_clover_eo_mrhs_info": (_I, _I, _I, _I, _I, _I, _I, _I, _P),
    # alpha, p, ap, x, r, x_out, r_out, partial, r2, n, nblocks, stream
    "qtt_cg_update_norm2_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I,
                                _P),
    # a, x, y, y_out, partial, n2, n, nblocks, bf16, stream
    "qtt_axpy_norm2": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _P),
    # out, psi, fat_here, fat_there, long_here, long_there, T, Z, Y, Xh,
    # parity, store_bf16, out_bf16, stream
    "qtt_staggered_eo_fused": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _P),
    # out, psi, u_here, u_bw, T, Z, Y, Xh, parity, nhop, store_bf16,
    # out_bf16, stream
    "qtt_staggered_eo_pass": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _P),
    # out, psi, u_here, u_bw, T, Z, Y, Xh, parity, nhop, accum, nrhs,
    # stream
    "qtt_staggered_eo_pass_mrhs": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _P),
    # out, psi, u, u_bw, T, Z, Y, X, rows, f64, tb_sign, stream
    "qtt_wilson_full": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # out, psi, u, u_bw, T, Z, Y, X, rows, tb_sign, nrhs, nb, stream
    "qtt_wilson_full_mrhs": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P),
    # T, Z, Y, X, rows, nb, info[6] (registers, shared bytes, blocks an SM,
    # threads, tiles a plane, blocks)
    "qtt_wilson_full_mrhs_info": (_I, _I, _I, _I, _I, _I, _P),
    # out, psi, u, u_bw, T, Z, Y, X, nhop, stream
    "qtt_staggered_full_pass": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # out, psi, fat, long, T, Z, Y, X, stream
    "qtt_staggered_full_fused": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # out, psi, u, u_bw, T, Z, Y, X, nhop, accum, nrhs, stream
    "qtt_staggered_full_pass_mrhs": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _I, _P),
    # T, Z, Y, X, nhop, accum, info[6] (registers, shared bytes, blocks an
    # SM, threads, tiles a plane, blocks)
    "qtt_staggered_full_pass_mrhs_info": (_I, _I, _I, _I, _I, _I, _P),
    # out, links, psi9, S, E, stream
    "qtt_coarse_apply": (_P, _P, _P, _I, _I, _P),
    # S, E, vec4, info[6] (registers, shared bytes, blocks an SM, link rows
    # a tile, lanes a row, blocks of the grid)
    "qtt_coarse_apply_info": (_I, _I, _I, _P),
    # out, links, psi9, S, E, nrhs, stream
    "qtt_coarse_apply_mrhs": (_P, _P, _P, _I, _I, _I, _P),
    # E, nrhs, vec4, info[6] (registers, shared bytes, blocks an SM,
    # threads, right-hand sides a chunk, chunks)
    "qtt_coarse_apply_mrhs_info": (_I, _I, _I, _P),
    # alpha, p, ap, x, r, x_out, r_out, partial, r2, n, nblocks, stream
    "qtt_cg_update_norm2_f64": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I,
                                _P),
    # out, psi, u_here, u_there, T, Z, Y, Xh, parity, store, out_store,
    # rows, tb_sign, stream
    "qtt_wilson_eo_there": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P),
    # out, psi, u_here, u_there, T, Z, Y, Xh, parity, rows, tb_sign, nrhs,
    # nb, stream
    "qtt_wilson_eo_there_mrhs": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _P),
    # out, psi, q_here, s_here, q_there, s_there, T, Z, Y, Xh, parity,
    # store, out_store, stream
    "qtt_wilson_eo_int8": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _P),
    # out, psi, u_here, u_bw, T, Z, Y, Xh, parity, store, out_store, rows,
    # tb_sign, stream (every array folded)
    "qtt_wilson_eo_fold": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P),
    # out, psi, u_here, u_bw, T, Z, Y, Xh, parity, rows, tb_sign, nrhs,
    # stream (every array folded)
    "qtt_wilson_eo_fold_mrhs": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _P),
    # T, Z, Y, Xh, rows, info[6] (registers, shared bytes, blocks an SM,
    # threads, tiles a (t, z) row, blocks)
    "qtt_wilson_eo_fold_mrhs_info": (_I, _I, _I, _I, _I, _P),
    # out, psi, fat_here, fat_there, long_here, long_there, T, Z, Y, Xh,
    # parity, store_bf16, out_bf16, stream (every array folded)
    "qtt_staggered_eo_fused_fold": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _I, _P),
    # out, psi, u_here, u_there, acc (or null), T, Z, Y, Xh, parity, nhop,
    # store_bf16, out_bf16, stream
    "qtt_staggered_eo_pass_v3": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _P),
    # out, psi, u, T, Z, Y, X, rows, tb_sign, stream
    "qtt_wilson_full_there": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # out, psi, gauge, T, Z, Y, X, f64, stream (canonical layout)
    "qtt_wilson_canonical": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # out, psi, u, u_bw, blk, T, Z, Y, X, rows, tb_sign, coeff, twist, tw_c,
    # stream
    "qtt_clover_full": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                        _F, _P),
    # src[], dst[], run[], runs[], stride[], n, stream (host arrays; the
    # halo exchange)
    "qtt_slab_exchange": (_P, _P, _P, _P, _P, _I, _P),
    # psi[], u[], out[], dn[], up[], n_ring, sel[], n_sel, L, S, mu, bidir,
    # stream (host arrays; the fused-halo hops)
    "qtt_wilson_axis_halo": (_P, _P, _P, _P, _P, _I, _P, _I, _I, _L, _I, _I,
                             _P),
    # dev, peer
    "qtt_enable_peer_access": (_I, _I),
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path          # the shared library
    seconds: float      # wall time of this call's build (0.0 when cached)
    log: str            # nvcc's output, -Xptxas -v resource lines included


def dispatch_device(*tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' for tensors that all lie on one device; raises for
    mixed devices or any other device type."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError("tensors on several devices: "
                         f"{sorted(map(str, devs))}")
    kind = next(iter(devs)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "cannot be built on this host")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Build the library unless a build of these exact sources exists."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        log = out_dir / "build.log"
        return BuildInfo(lib, 0.0, log.read_text() if log.is_file() else "")
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    tmp = BUILD_ROOT / f"tmp-{os.getpid()}-{threading.get_ident()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    procs = []
    for name in SOURCES:
        obj = tmp / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== nvcc {name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp / LIB_NAME),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs.append(f"== link (rc {link.returncode})\n{link.stdout}")
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n"
                           + "\n".join(logs))
    log = "\n".join(logs)
    (tmp / "build.log").write_text(log)
    try:
        tmp.rename(out_dir)
    except OSError:
        # another process finished the same build first; use its copy
        shutil.rmtree(tmp, ignore_errors=True)
    return BuildInfo(lib, time.perf_counter() - t0, log)


_loaded: dict = {}
_load_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call), with argtypes and
    restype declared for every C entry point."""
    with _load_lock:
        if "lib" not in _loaded:
            lib = ctypes.CDLL(str(build().path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _loaded["lib"] = lib
        return _loaded["lib"]


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def kernel_info(entry: str, *args: int) -> dict:
    """A kernel's resources from its C query entry (``entry`` takes
    ``args`` and an int[6]): ptxas registers a thread, dynamic shared
    memory a block in bytes and resident blocks an SM (from
    cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    and three entries of the kernel's own (``extra``)."""
    info = (ctypes.c_int * 6)()
    rc = getattr(library(), entry)(*args, ctypes.cast(info, ctypes.c_void_p))
    check_launch(rc, entry)
    return {"registers": info[0], "smem_bytes": info[1],
            "blocks_per_sm": info[2], "extra": list(info[3:])}


def require(t: torch.Tensor, name: str, shape=None,
            dtype=torch.float32) -> None:
    """Raise unless ``t`` has ``dtype``, is contiguous and (when given)
    has ``shape`` — what a kernel reading raw pointers needs."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel needs a contiguous tensor")
