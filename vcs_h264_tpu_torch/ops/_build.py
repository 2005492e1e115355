"""Build the CUDA kernels in `vcs_h264_tpu_torch/csrc/` with nvcc and load
them through ctypes.

At first use each `.cu` source is compiled for Hopper (`sm_90a`) by its own
nvcc process, all of them at once, and the objects are linked into one
shared library with a plain C interface, placed in `vcs_h264_tpu_torch/build/`
under a name keyed by a hash of the sources (the `.cuh` headers included)
and flags, so an edited source is rebuilt and an unchanged one is loaded as
is. Nothing here runs at import time; a missing nvcc or a failed build
raises.

`--fmad=false` keeps nvcc from contracting a*b+c into one fused multiply-add:
the kernels' float arithmetic then rounds after every operation, as the
plain PyTorch versions and the JAX package do, so round-half-even at .5 ties
flips only where a sum's order differs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
              "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
# C entry point -> argument types; every one returns its cudaError_t but
# vcs_sad_search_form, which returns a form.
SIGNATURES = {
    # curs, refs, mv_out, G, F, C, H, W, bs, reach, step, static_threshold,
    # stream
    "vcs_sad_search": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # C, bs, reach, step, aligned, shmem_out, threads_out -> the form
    # vcs_sad_search takes (motion_cuda.SAD_FORMS); launches nothing
    "vcs_sad_search_form": (_I, _I, _I, _I, _I, _IP, _IP),
    # mv, refs, curs, tables (in HOST memory: they become the kernel's
    # parameter), coeffs_out, G, F, H, W, stream
    "vcs_fused_p_encode": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # mv, refs, coeffs, tables (in host memory too), frames_out, G, F, H, W,
    # stream
    "vcs_fused_p_decode": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # the bare-plane pairs, luma (C = 1) and 4:2:0 chroma (C = 2): as the
    # two above (tables in host memory too), H and W being the plane's own
    "vcs_plane_encode": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "vcs_plane_decode": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "vcs_c420_encode": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "vcs_c420_decode": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # planes, qcoef_out, modes_out, escape_out, recon_out, N, H, W, qstep,
    # magic, shift (intra_cuda.quant_magic), row_warps
    # (intra_cuda.encode_form), stream
    "vcs_intra_encode": (_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_uint, _I,
                         _I, _P),
    # res, modes, escape, out, scratch (int16 like res, or null: see the
    # source), N, H, W, qstep, clip, stream
    "vcs_intra_decode": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # mv, refs, out, G, F, C, H, W, bs, form (motion_cuda.compensate_form),
    # stream
    "vcs_compensate": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
build_seconds = None      # wall time of the last nvcc run, None if cached


def find_nvcc() -> str:
    """nvcc on PATH, then in $CUDA_HOME/bin, then in /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or in /usr/local/cuda/bin; "
        "the CUDA kernels of vcs_h264_tpu_torch cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_file(prefix: str, flags, sources) -> Path:
    """BUILD/<prefix>_<key>.so, the key a hash of the flags and the sources:
    each source's name and bytes, or the bytes alone of a single source."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        if len(sources) > 1:
            h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"{prefix}_{h.hexdigest()[:16]}.so"


def cached_library(prefix: str, flags, sources, build) -> Path:
    """The library of `sources` built with `flags`, at `library_file`.
    Where it is not yet, `build(tmp)` writes it into a file of this process
    and thread, which is then renamed into place: processes that build at
    once never load a partial library."""
    out = library_file(prefix, flags, sources)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        build(tmp)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def library_path() -> Path:
    return library_file("libvcs_kernels", NVCC_FLAGS, _sources())


def _run_all(cmds) -> None:
    """Run the commands at once; raise with the first failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _compile(out: Path) -> None:
    """Each .cu source into an object by its own nvcc, all at once, then
    one link into `out`."""
    global build_seconds
    nvcc = find_nvcc()
    objdir = out.with_suffix(".obj")
    objdir.mkdir(exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [objdir / f"{s.stem}.o" for s in srcs]
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                  for s, o in zip(srcs, objs)])
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(out),
                   *map(str, objs)]])
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    build_seconds = time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(cached_library(
                "libvcs_kernels", NVCC_FLAGS, _sources(), _compile)))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
