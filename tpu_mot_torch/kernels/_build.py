"""Build and load the port's CUDA kernels.

Every `.cu` file under tpu_mot_torch/csrc/ is compiled by nvcc for Hopper
(`sm_90a`), one nvcc process per source, all started together, and the
objects are linked into one shared library with a plain C interface,
loaded with ctypes.  The library is built at first use into
tpu_mot_torch/_build/, named by a hash of the sources, so an edit rebuilds
and an unchanged checkout reuses its build.  Compiling is seconds: no
source includes PyTorch's headers.

Each C entry point launches on the stream it is given and returns
cudaGetLastError(); `check` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry point -> argument types (every pointer and the stream as void*).
SIGNATURES = {
    "tpu_mot_auction_solve": (_P, _P, _P, _I, _I, _F, _I, _P),
    "tpu_mot_auction_max_n": (),
    "tpu_mot_auction_shared_max_n": (),
    "tpu_mot_auction_info": (_I, _P),
    "tpu_mot_roi_extract": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _F, _P),
    "tpu_mot_roi_extract_rows": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _I, _I, _I, _F, _P),
    "tpu_mot_roi_extract_scales": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                                   _I, _I, _I, _I, _I, _F, _P),
    "tpu_mot_roi_max_s": (),
    "tpu_mot_roi_info": (_I, _I, _P),
    "tpu_mot_roi_scales_info": (_I, _I, _P),
    "tpu_mot_kcf_smem_limit": (),
    "tpu_mot_kcf_detect_smem_bytes": (_I, _I),
    "tpu_mot_kcf_detect_info": (_I, _I, _P),
    "tpu_mot_kcf_train_smem_bytes": (_I, _I),
    "tpu_mot_kcf_train_info": (_I, _I, _P),
    "tpu_mot_kcf_detect": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "tpu_mot_kcf_train": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                          _F, _P),
    "tpu_mot_kcf_train_shift_info": (_P,),
    "tpu_mot_kcf_train_shift": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _F, _F, _P),
    "tpu_mot_epilogue": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _P),
}


def find_nvcc() -> str:
    """nvcc of the CUDA toolkit that PyTorch finds
    (`torch.utils.cpp_extension.CUDA_HOME`)."""
    from torch.utils import cpp_extension
    home = cpp_extension.CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        f"nvcc not found (PyTorch's CUDA home is {home}): the port's CUDA "
        "kernels are built from tpu_mot_torch/csrc at first use and need "
        "the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(build_dir: Path | None = None) -> tuple[Path, float, str]:
    """Compile csrc/*.cu into build_dir unless a build of these exact
    sources exists.  Returns (library path, seconds spent compiling and
    linking (0.0 when reused), compiler output)."""
    build_dir = Path(build_dir or BUILD_DIR)
    tag = source_hash()
    lib = build_dir / f"libtpu_mot_kernels_{tag}.so"
    log = lib.with_suffix(".log")
    if lib.is_file():
        return lib, 0.0, log.read_text() if log.is_file() else ""
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    srcs = [p for p in _sources() if p.suffix == ".cu"]
    objs = [build_dir / f"{p.stem}_{tag}.{pid}.o" for p in srcs]
    tmp = lib.with_name(f"{lib.name}.{pid}.tmp")
    t0 = time.perf_counter()
    procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                                str(obj)], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True), src)
             for src, obj in zip(srcs, objs)]
    outputs, failed = [], []
    for proc, src in procs:
        out, _ = proc.communicate()
        outputs.append(out)
        if proc.returncode != 0:
            failed.append(f"{src.name} (rc {proc.returncode})")
    if not failed:
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        outputs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link (rc {link.returncode})")
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    output = "".join(outputs)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{output}")
    log.write_text(output)
    os.replace(tmp, lib)          # atomic: concurrent builders both succeed
    return lib, seconds, output


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library, built on first call and bound with argtypes."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def launch_info(fn, *shape: int) -> dict:
    """What one of the `*_info` entry points says a kernel launches at
    `shape`: code path (int), threads per CTA, registers per thread,
    shared memory per CTA (dynamic; K6's is static), CTAs resident per
    SM."""
    info = (ctypes.c_int * 5)()
    check(fn(*shape, info), fn.__name__)
    return dict(zip(("path", "threads", "registers", "smem_bytes",
                     "ctas_per_sm"), info))


def on_card(what: str, t) -> bool:
    """Which version a kernel wrapper runs for tensor t: False (the plain
    version) on the CPU, True (the kernel) on a CUDA card; raises for any
    other device."""
    if t.device.type == "cpu":
        return False
    if not t.is_cuda:
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
