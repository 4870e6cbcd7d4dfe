"""Build and load the CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with ``ctypes``. The
build runs at first use — nothing is compiled when a module is imported —
and all sources compile in parallel, one ``nvcc`` process each. Libraries
are cached in :func:`build_dir` (``build/repro_torch/`` of the checkout by
default) under a hash of their sources and flags, so an unchanged kernel
is not rebuilt.

Every launching C entry point returns the ``cudaError_t`` of its launch;
:func:`check` raises on anything but 0. A few entries return sizes
instead (``RESTYPES``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("hash64", "cuckoo_query", "cuckoo_query_unfused", "cuckoo_insert",
           "cuckoo_insert_unfused", "cuckoo_insert_bulk", "cuckoo_mixed",
           "bloom_query", "bloom_insert", "kmer_pack", "flash_attention",
           "gqf_serial")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _U32, _U64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                        ctypes.c_uint64)
_I32, _F32 = ctypes.c_int32, ctypes.c_float
# Five uint32 sizes, the uint64 seed and the stream (cuckoo and Bloom).
_GEOMETRY = [_U32, _U32, _U32, _U32, _U32, _U64, _P]
ARGTYPES = {
    "hash64_launch": [_P, _P, _P, _I64, _U32, _U64, _P],
    "cuckoo_query_launch": [_P, _P, _P, _I64] + _GEOMETRY,
    "cuckoo_query_unfused_launch": [_P, _P, _P, _I64] + _GEOMETRY,
    "cuckoo_insert_launch": [_P, _P, _P, _P, _I64] + _GEOMETRY,
    "cuckoo_insert_unfused_launch": [_P, _P, _P, _P, _I64] + _GEOMETRY,
    # table, keys, valid, ok, n, scratch, log2 of a window's buckets,
    # windows (1: the insert pass alone).
    "cuckoo_insert_bulk_launch": [_P, _P, _P, _P, _I64, _P, _U32, _U32]
                                 + _GEOMETRY,
    "cuckoo_insert_bulk_scratch_bytes": [_I64, _U32],
    # table, keys, ops, valid, scratch, log2 of its slots, n, ok, state.
    "cuckoo_mixed_launch": [_P, _P, _P, _P, _P, _U32, _I64, _P, _P] + _GEOMETRY,
    # table, sorted key values, order, its length, scratch, counts, ok.
    "cuckoo_mixed_walk_launch": [_P, _P, _P, _I64, _P, _P, _P] + _GEOMETRY,
    "bloom_query_launch": [_P, _P, _P, _I64] + _GEOMETRY,
    # table, keys, hit, n, scratch, log2 of a window's blocks, windows.
    "bloom_query_windowed_launch": [_P, _P, _P, _I64, _P, _U32, _U32]
                                   + _GEOMETRY,
    "bloom_query_scratch_bytes": [_I64, _U32],
    "bloom_query_l2_bytes": [],
    "bloom_insert_launch": [_P, _P, _P, _I64] + _GEOMETRY,
    # bases, out, m, k, canonical, the stream.
    "kmer_pack_launch": [_P, _P, _I64, _U32, _U32, _P],
    # q, k, v, out, B, then KVH, g, Sq, Sk, D, Dv, the strides of q, k, v
    # and out (int64 arrays), dtype, out dtype, variant, causal, window,
    # q_offset, the scale and the stream.
    "flash_attention_launch": [_P, _P, _P, _P, _I64] + [_I32] * 6 + [_P] * 4
                              + [_I32] * 6 + [_F32, _P],
    # table, rem, home, valid, ok, count, n, num_slots, remainder bits,
    # max_probe, the stream.
    "gqf_insert_serial_launch": [_P] * 6 + [_I64, _U64, _U32, _U32, _P],
    "gqf_delete_serial_launch": [_P] * 6 + [_I64, _U64, _U32, _U32, _P],
}

# Entry points beyond ``<name>_launch``, and those that do not return a
# ``cudaError_t``.
EXPORTS = {"bloom_query": ("bloom_query_launch", "bloom_query_windowed_launch",
                           "bloom_query_scratch_bytes", "bloom_query_l2_bytes"),
           "cuckoo_insert_bulk": ("cuckoo_insert_bulk_launch",
                                  "cuckoo_insert_bulk_scratch_bytes"),
           "cuckoo_mixed": ("cuckoo_mixed_launch", "cuckoo_mixed_walk_launch"),
           "gqf_serial": ("gqf_insert_serial_launch",
                          "gqf_delete_serial_launch")}
RESTYPES = {"bloom_query_scratch_bytes": _I64, "bloom_query_l2_bytes": _I64,
            "cuckoo_insert_bulk_scratch_bytes": _I64}

_LIBS: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on a machine with the GPU")
    return nvcc


def build_dir() -> Path:
    """Where the libraries go: ``$REPRO_TORCH_BUILD_DIR`` if set; else
    ``build/repro_torch/`` of the checkout when the package runs from its
    ``src/`` tree; else ``repro_torch-build/`` under the temporary
    directory (an installed package writes nothing beside site-packages)."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    src = Path(__file__).resolve().parents[2]
    if src.name == "src" and (src.parent / "pyproject.toml").exists():
        return src.parent / "build" / "repro_torch"
    return Path(tempfile.gettempdir()) / "repro_torch-build"


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every kernel that is not built yet, in parallel.

    Returns ``{name: compiler output}`` for what was compiled (``-Xptxas
    -v`` prints each kernel's registers and spills). Raises if any
    compilation fails.
    """
    build_dir().mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        path = _lib_path(name)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for export in EXPORTS.get(name, (f"{name}_launch",)):
            fn = getattr(lib, export)
            fn.argtypes = ARGTYPES[export]
            fn.restype = RESTYPES.get(export, ctypes.c_int)
        _LIBS[name] = lib
    return lib


def geometry(config) -> tuple:
    """The geometry arguments every cuckoo kernel takes, from a config."""
    return (config.num_buckets, config.bucket_size, config.fp_bits,
            {"xor": 0, "offset": 1}[config.policy],
            {"xxhash64": 0, "fmix32": 1}[config.hash_kind],
            config.seed & ((1 << 64) - 1))


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
