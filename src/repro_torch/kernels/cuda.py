"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` (plus the shared headers `csrc/*.cuh`) compiles with
`nvcc -gencode arch=compute_90a,code=sm_90a` into its own shared library
under `build/torch_ext/` at the repo root, exporting `extern "C"` launchers
that take device pointers, sizes and the current stream and return the
`cudaGetLastError()` code. Libraries are loaded with `ctypes`; the file
name carries a hash of the sources, so an edited source is rebuilt and a
stale library is never loaded. `build_all()` starts one `nvcc` per source
at once and waits for all of them.

Nothing here runs at import: the CPU test suite imports every module on a
machine without `nvcc`. A failed build or a launch error raises; there is
no fallback to the plain versions.

`LAUNCHES` counts kernel launches by kernel name: each wrapper adds one
where it launches a kernel and nowhere else, so a run can show that a
path went through the kernels. The two fused tier kernels also count by
warm layout (`tier_find/level`, `tier_find/block`, ...), so a run can show
which walk they took.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
KERNELS = ("skiplist_search", "hash_probe", "tier_find", "tier_apply",
           "bskiplist_walk", "pq_pop", "splitorder_probe",
           "paged_attention", "flash_attention", "selective_scan",
           "selective_scan_bwd")
WARM_LAYOUTS = ("level", "block")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every exported launcher (pointers and the stream as c_void_p)
_SIGNATURES = {
    "skiplist_search_launch": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P,
                               _I, _P],
    "hash_probe_launch": [_P, _P, _I, _P, _I, _I, _P, _P, _I, _P],
    "hash_probe_slots": [_I],
    "tier_find_launch": [_P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _I, _I, _P,
                         _P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                         _P, _I, _P],
    "tier_find_slots": [_I, _I],
    "tier_apply_member_launch": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _P, _P,
                                 _P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _I,
                                 _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _P],
    "tier_apply_member_slots": [_I],
    "tier_apply_scan_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P, _P, _P, _P],
    "bskiplist_walk_launch": [_P, _I, _P, _I, _I, _P, _P, _I, _I, _P, _P, _I,
                              _P],
    "bskiplist_walk_slots": [_I],
    "pq_pop_launch": [_P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _P,
                      _I, _I, _P, _P, _I, _P],
    "splitorder_probe_launch": [_P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _I,
                                _P],
    "splitorder_probe_slots": [_I],
    "paged_attention_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _F, _P],
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _F, _P],
    "selective_scan_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _I, _I, _P],
    "selective_scan_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _P],
}

LAUNCHES = {name: 0 for name in KERNELS}
LAUNCHES.update({f"{name}/{lay}": 0 for name in ("tier_find", "tier_apply")
                 for lay in WARM_LAYOUTS})
# the scan's forward launches that also save its chunk states (autograd)
LAUNCHES["selective_scan/save"] = 0
# the same launches by call shape, for the wrappers that give one:
# {(name or name/variant, shape): count}
SHAPE_LAUNCHES: collections.Counter = collections.Counter()
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SHAPE_LAUNCHES.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(str(Path(CUDA_HOME) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=KERNELS) -> dict:
    """Compile every kernel library that is not built yet, one `nvcc` per
    source, all started together. Returns {name: seconds} of the builds
    that ran (wall time of the whole parallel build). Raises on failure."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    errors = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    dt = time.perf_counter() - t0
    return {n: dt for n in todo}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in _SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def launch(kernel: str, fn: str, *args, variant: str | None = None,
           shape=None) -> None:
    """Call launcher `fn` of kernel library `kernel` on the current stream
    and count one launch of `kernel` (and of `kernel/variant` when a
    variant is given: a tier kernel's warm layout, the scan's saving
    forward; and in `SHAPE_LAUNCHES` under the call's `shape` when one is
    given); raise on a launch error."""
    lib = library(kernel)
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} failed with CUDA error {err}")
    LAUNCHES[kernel] += 1
    name = kernel
    if variant is not None:
        name = f"{kernel}/{variant}"
        LAUNCHES[name] += 1
    if shape is not None:
        SHAPE_LAUNCHES[(name, shape)] += 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device)."""
    return _sm_count(torch.device(device).index or 0)


def team_width(k: int, widths, sms: int, slots) -> int:
    """Lanes a query for a launch of k queries, a team of lanes each, on a
    card of `sms` SMs; `widths` are the kernel's instances, widest first,
    and `slots(team)` is the resident threads an SM of the instance for
    `team` (its occupancy, which its registers set). A wider team runs a
    query's probes in fewer dependent rounds, but it pays only while all k
    teams are resident at once, since a second wave waits on the first:
    the widest of `widths` whose k teams are, else the narrowest."""
    for team in widths:
        if k * team <= sms * slots(team):
            return team
    return widths[-1]


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer of a tensor (None passes a null pointer)."""
    return None if t is None else t.data_ptr()


def check_cuda(name: str, *tensors) -> None:
    """Raise unless every given tensor is a contiguous CUDA tensor."""
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def warm_args(name: str, warm):
    """The warm-walk arguments shared by the fused tier launchers (blocked,
    keys, child, offsets, levels, width, term keys, term mark, C, padded
    length) and the layout's name for the launch count; `warm` is a
    `SkiplistLayout` or a `BSkiplistLayout` (`core.layout`)."""
    from repro_torch.core.layout import BSkiplistLayout
    if warm.num_levels > 64:
        raise ValueError(f"{name}: at most 64 index levels")
    if isinstance(warm, BSkiplistLayout):
        check_cuda(name, warm.blk, warm.term_keys, warm.term_mark)
        return (1, ptr(warm.blk), None, None, warm.num_levels,
                warm.blk.shape[1], ptr(warm.term_keys), ptr(warm.term_mark),
                warm.term_keys.shape[0], warm.n_pad), "block"
    check_cuda(name, warm.lvl_keys, warm.lvl_child, warm.lvl_off,
               warm.term_keys, warm.term_mark)
    cap = warm.term_keys.shape[0]
    return (0, ptr(warm.lvl_keys), ptr(warm.lvl_child), ptr(warm.lvl_off),
            warm.num_levels, warm.c1, ptr(warm.term_keys),
            ptr(warm.term_mark), cap, cap), "level"
