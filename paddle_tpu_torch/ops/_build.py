"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with nvcc, at first use, into its own shared
library with a plain C interface, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so csrc/<name>.cu

* Only the sources in the checkout are used; the library's file name
  carries a hash of its source and of every ``csrc/*.cuh`` header, so
  an edited source builds anew and a stale library is never loaded.
* `build` starts one nvcc per missing library, all at once, and waits
  for them together.
* A failed build raises with nvcc's stderr.
* The build directory is ``build/kernels`` at the checkout's root
  (gitignored), or ``$PADDLE_TPU_TORCH_BUILD_DIR``.

The C functions take device pointers and PyTorch's current stream as
integers, launch, and return ``cudaGetLastError()``; `launch` declares
their argument types, calls them and turns a non-zero code into an
exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["KERNELS", "build", "build_dir", "dtype_code", "launch",
           "stream_ptr"]

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("flash_fwd", "flash_bwd", "flash_bwd_fused", "decode_attention",
           "paged_attention", "matmul_bias_act", "matmul_bwd",
           "conv_bn_relu", "conv_bn_stats")
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHERS = {}
_LOCK = threading.Lock()
# nvcc's stderr (ptxas register / spill report) of the builds this
# process ran, by kernel name
build_logs = {}


def build_dir():
    env = os.environ.get("PADDLE_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc():
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and %s): the CUDA kernels of paddle_tpu_torch build "
        "from source at first use and need the CUDA toolkit"
        % DEFAULT_NVCC.parent)


def _digest(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / (name + ".cu")] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name):
    return build_dir() / ("%s-%s.so" % (name, _digest(name)))


def build(names=KERNELS):
    """Compile every library of ``names`` that is not built yet, one
    nvcc per source, all started together.  Returns ``{name: path}``;
    raises `RuntimeError` with nvcc's stderr if any build fails."""
    for name in names:
        if name not in KERNELS:
            raise ValueError("unknown kernel %r (have %s)" % (name, KERNELS))
    paths = {name: _lib_path(name) for name in names}
    todo = [n for n in names if not paths[n].is_file()]
    if not todo:
        return paths
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = paths[name].with_suffix(".so.tmp%d" % os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / (name + ".cu"))]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        build_logs[name] = (out or "") + (err or "")
        if proc.returncode != 0:
            failed.append("%s (exit %d):\n%s" % (name, proc.returncode, err))
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed to build\n" + "\n".join(failed))
    return paths


def _launcher(lib_name, fn_name, argtypes):
    with _LOCK:
        hit = _LAUNCHERS.get((lib_name, fn_name))
        if hit is None:
            lib = ctypes.CDLL(str(build([lib_name])[lib_name]))
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            hit = _LAUNCHERS[(lib_name, fn_name)] = (fn, lib)
        return hit


def launch(lib_name, fn_name, argtypes, *args):
    """Call the C launcher ``fn_name`` of kernel library ``lib_name``
    (built and loaded at first use) with ``args`` typed by ``argtypes``;
    raise if it returns a CUDA error (a refused or failed launch)."""
    fn, lib = _launcher(lib_name, fn_name, argtypes)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError("%s: CUDA launch failed with error %d (%s)"
                           % (fn_name, rc, lib.cuda_error_string(rc).decode()))


def query(lib_name, fn_name, argtypes, *args):
    """The int that the host function ``fn_name`` of kernel library
    ``lib_name`` returns (a size, not a CUDA error)."""
    return _launcher(lib_name, fn_name, argtypes)[0](*args)


def dtype_code(t):
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError("CUDA kernels take float32 or bfloat16, got %s"
                        % t.dtype)
    return code


def stream_ptr(device):
    """PyTorch's current CUDA stream on ``device``, as an integer."""
    return torch.cuda.current_stream(device).cuda_stream
