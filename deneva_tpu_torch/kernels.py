"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

The kernels are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and loaded with ``ctypes`` — the same
binding style as the repo's host-side ``native/`` library.  Nothing here
runs at import: the library is built at the first CUDA launch, into
``deneva_tpu_torch/_build/`` (git-ignored), keyed by a hash of the
sources and flags so an unchanged tree reuses its build.

Each kernel entry point is a :class:`Kernel`: a C symbol plus its ctypes
signature and a plain launch counter.  A wrapper calls
:meth:`Kernel.launch` exactly where it launches on the card; the counter
is what ``chip_smoke.py`` reads to show the main path went through the
kernel.  A non-zero return (``cudaGetLastError()`` after the launches)
raises — there is no fallback to the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("prng.cu", "forward.cu", "ycsb.cu",
           "conflict.cu", "scatter.cu", "timestamp.cu", "version.cu",
           "levels.cu", "maat.cu", "index.cu", "table.cu", "tpcc.cu",
           "pps.cu", "frontier.cu", "depgraph.cu", "audit.cu", "mc.cu",
           "router.cu")
HEADERS = ("common.cuh", "threefry.cuh", "hashing.cuh", "value_law.cuh",
           "bits.cuh", "radix.cuh", "cluster.cuh")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = (ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
build_log = ""          # nvcc's stderr of the build this process loaded


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of deneva_tpu_torch "
                       "are built at first CUDA use and need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile every source in parallel (one nvcc each), link one shared
    library, return (path, compiler log).  Reuses an existing build of
    the same sources.  Raises on any compiler error."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    lib = BUILD_DIR / f"libdeneva_kernels_{tag}.so"
    logf = BUILD_DIR / f"build_{tag}.log"
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib, logf.read_text() if logf.exists() else ""
        nvcc = _nvcc()
        procs = []
        for src in SOURCES:
            obj = BUILD_DIR / f"{Path(src).stem}_{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src}\n{out}")
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                               + "\n".join(log))
        tmp = lib.with_suffix(".so.tmp")
        link = subprocess.run(
            [nvcc, ARCH, "-shared", "-o", str(tmp),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        text = "\n".join(log)
        logf.write_text(text)
        os.replace(tmp, lib)
        return lib, text


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use in this process."""
    global _lib, build_log
    if _lib is None:
        path, build_log = build()
        _lib = ctypes.CDLL(str(path))
    return _lib


def ptxas_lines(log: str) -> list[str]:
    """The register / shared-memory lines of a build log."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "Compiling entry" in ln]


class Kernel:
    """One C entry point of the kernel library, with its launch count."""

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            # the kernels also return 1 (invalid value) for a size they do
            # not take: shared memory that does not fit, too long a row
            why = " (invalid value, or a size the kernel does not take)" \
                if err == 1 else ""
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at "
                               f"launch{why}")
        self.launches += 1


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
U32 = ctypes.c_uint
U64 = ctypes.c_ulonglong
F32 = ctypes.c_float
F64 = ctypes.c_double


def layout(symbol: str, *args: int) -> tuple[int, ...]:
    """Ask the kernel library how a kernel lays out a launch at the given
    sizes: its host-only entry point ``symbol`` (int arguments, then a
    pointer to three int64) fills in the three numbers, launches nothing
    and counts no launch.  Raises where the kernel takes no such size."""
    out = (ctypes.c_longlong * 3)()
    fn = getattr(library(), symbol)
    fn.argtypes = [I32] * len(args) + [P]
    fn.restype = ctypes.c_int
    if fn(*args, ctypes.cast(out, P)) != 0:
        raise ValueError(f"{symbol}: no layout for sizes {args}")
    return tuple(out)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None,
          device: torch.device | None = None) -> None:
    """Refuse what a kernel does not take: wrong device, dtype, shape or
    a non-contiguous layout."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    the CPU.  Asking for CUDA where there is none raises — the port
    never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deneva_tpu_torch runs on CUDA by default, and "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain-version route);
    False when all are on CUDA.  Anything else raises."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")


def all_kernels() -> dict[str, Kernel]:
    """Every kernel of the main path, by name (imports the modules that
    own them)."""
    from deneva_tpu_torch.cc import (base, depgraph, dgcc, maat, router,
                                     timestamp)
    from deneva_tpu_torch.ops import conflict, forward, prng, scatter
    from deneva_tpu_torch.storage import index, table
    from deneva_tpu_torch.workloads import pps, tpcc, ycsb
    return {"K1_sort_lanes": forward.K1_SORT,
            "K2_plan_scans": forward.K2_SCAN,
            "K3_forward_execute": ycsb.K3_EXEC,
            "K4a_threefry_split": prng.K4_SPLIT,
            "K4b_ycsb_generate": ycsb.K4_GEN,
            "K5K6_build_incidence": conflict.K56_INCIDENCE,
            "K7_overlap": conflict.K7_OVERLAP,
            "K8_first_fit": conflict.K8_FIRST_FIT,
            "K9a_wavefront_levels": conflict.K9A_WAVEFRONT,
            "K9b_precedence_levels": conflict.K9B_PRECEDENCE,
            "K10_last_writer": scatter.K10_LAST_WRITER,
            "K11a_maat_reach": maat.K11A_REACH,
            "K11b_maat_peel": maat.K11B_PEEL,
            "K12a_watermark_check": timestamp.K12A_CHECK,
            "K12b_commit_watermarks": timestamp.K12B_COMMIT,
            "K12c_version_read": ycsb.K12C_READ,
            "K12d_version_push": table.K12D_PUSH,
            "K14a_hash_lookup": index.K14A_LOOKUP,
            "K14b_sorted_lookup": index.K14B_LOOKUP,
            "K14c_scatter_add": table.K14C_SCATTER_ADD,
            "K14d_append": table.K14D_APPEND,
            "K14e_index_merge": index.K14E_MERGE,
            "K14e_sorted_probe": index.K14E_PROBE,
            "K19_tpcc_generate": tpcc.K19_GEN,
            "K20_pps_generate": pps.K20_GEN,
            "K13a_repair_frontier": base.K13A_FRONTIER,
            "K15a_lane_sort": depgraph.K15A_SORT,
            "K15b_seg_scans": depgraph.K15B_SCANS,
            "K16_dgcc_relax": dgcc.K16_RELAX,
            "K13b_conflict_density": base.K13B_DENSITY,
            "K15c_audit_scans": depgraph.K15C_SCAN,
            "K15c_compact_edges": depgraph.K15C_COMPACT,
            "K17_audit_observe[lanes]": base.K17_LANES,
            "K17_audit_observe[stamps]": base.K17_OBSERVE,
            "K18a_mc_defer": forward.K18A_DEFER,
            "K18b_mc_pack": forward.K18B_PACK,
            "K21_cross_group_defer": router.K21_DEFER}
