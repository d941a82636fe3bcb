"""CUDA column pass: the 'cuda' engine of the four-step plans.

The kernel (ops/cuda/colpass.cu) runs one whole four-step pass — an
nn-point transform down every column of a (batch, nn, cols) matrix, with
an optional elementwise twiddle multiply on load and on store and an
optional transposed store — reading and writing device memory once. It
follows twiddles.col_network's nested R x S schedule, so its output is
the XLA engine's bit for bit. Word primes p < 2^31; column sizes 256 to
2048 (both four-step factors must be one of them).

The shared library is compiled from the repository's source by nvcc for
sm_90a at first use, into ``<checkout>/build/cuda`` (keyed by a hash of the
source), or ahead of time with ``python -m ntt_aie.ops.cuda_colpass``.
There is no interpret mode: on a machine without an NVIDIA GPU backend,
nvcc or the built library, building a column pass raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ntt_aie import twiddles as tw

SUPPORTED_COLUMNS = (256, 512, 1024, 2048)
TARGET = "ntt_colpass"
_SRC = Path(__file__).resolve().parent / "cuda" / "colpass.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
_registered = False


def supports(field, n1: int, n2: int) -> bool:
    """True when the kernel covers a four-step plan with this split."""
    p = field.p
    return (p < (1 << 31) and p % 2 == 1 and n1 in SUPPORTED_COLUMNS
            and n2 in SUPPORTED_COLUMNS)


def split_rs(nn: int) -> tuple[int, int]:
    """(R, S) of the nested column network (twiddles.nested_col_split)."""
    R = tw.nested_col_split(nn)
    return R, nn // R


def shoup_pairs(vals, p: int) -> np.ndarray:
    """Field values -> (..., 2) uint32 [w, floor(w * 2^32 / p)] pairs, the
    kernel's operand form for every constant multiply."""
    v = np.asarray(vals).astype(np.uint64)
    ws = (v << np.uint64(32)) // np.uint64(p)
    return np.ascontiguousarray(
        np.stack([v.astype(np.uint32), ws.astype(np.uint32)], axis=-1))


def colpass_tables(field, nn: int, *, inverse: bool) -> np.ndarray:
    """Stage and mid twiddles of one column pass as (n_entries, 2) pairs:
    phase A's stage vectors, phase B's, then the (nn,) mid twiddles on the
    (R, S) row-major layout — the kernel's table operand. Forward: A = the
    R-point DIF, B = the S-point DIF. Inverse: A = the S-point DIT, B =
    the R-point DIT, all with inverse roots (col_network's DIT mirror)."""
    R, S = split_rs(nn)
    if inverse:
        a = tw.dit_stage_twiddles(field, S, inverse=True)
        b = tw.dit_stage_twiddles(field, R, inverse=True)
    else:
        a = tw.dif_stage_twiddles(field, R)
        b = tw.dif_stage_twiddles(field, S)
    net = tw.col_network(field, nn, direction="dit" if inverse else "dif",
                         inverse=inverse)
    vals = np.concatenate([np.concatenate(a), np.concatenate(b),
                           np.asarray(net["mid"]["wmid"])])
    return shoup_pairs(vals, field.p)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("the CUDA column pass needs nvcc (CUDA toolkit) "
                           "to build its kernel library")
    return path


def build_library() -> Path:
    """Compile ops/cuda/colpass.cu into build/cuda (once per source
    version) and return the shared library's path."""
    import jax

    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:12]
    so = _BUILD_DIR / f"libntt_colpass_{tag}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    return so


def _register() -> None:
    global _registered
    if _registered:
        return
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            "the CUDA column pass needs an NVIDIA GPU backend; JAX reports "
            f"{backend!r}")
    lib = ctypes.cdll.LoadLibrary(str(build_library()))
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.NttColpass),
                                platform="CUDA")
    _registered = True


def make_colpass(field, nn: int, *, inverse: bool,
                 transpose_out: bool = False, pre=None, post=None):
    """One column pass over (B, nn, cols) uint32 arrays.

    inverse=False: forward DIF (natural in, col_network's spectral order
    out); inverse=True: the DIT mirror with inverse twiddles (unscaled).
    pre: optional host (nn, cols) matrix of field values multiplied in on
    load; post: optional host matrix in the OUTPUT orientation, multiplied
    in on store. transpose_out writes (B, cols, nn). Outputs are
    canonical. Raises unless the GPU backend and the kernel are there."""
    import jax
    import jax.numpy as jnp

    if nn not in SUPPORTED_COLUMNS:
        raise ValueError(f"the CUDA column pass supports columns of "
                         f"{SUPPORTED_COLUMNS} rows, not {nn}")
    _register()
    p = field.p
    R, S = split_rs(nn)
    tabs = jnp.asarray(colpass_tables(field, nn, inverse=inverse))
    dummy = jnp.zeros((1, 2), jnp.uint32)
    pre_d = jnp.asarray(shoup_pairs(pre, p)) if pre is not None else dummy
    post_d = jnp.asarray(shoup_pairs(post, p)) if post is not None else dummy
    attrs = dict(logr=np.int64(R.bit_length() - 1),
                 logs=np.int64(S.bit_length() - 1),
                 inverse=np.int64(inverse),
                 transpose_out=np.int64(transpose_out),
                 has_pre=np.int64(pre is not None),
                 has_post=np.int64(post is not None), p=np.int64(p))

    def run(x):
        b, rows, cols = x.shape
        out = (b, cols, rows) if transpose_out else (b, rows, cols)
        if pre is not None and pre.shape != (rows, cols):
            raise ValueError(f"pre table {pre.shape} != {(rows, cols)}")
        if post is not None and post.shape != out[1:]:
            raise ValueError(f"post table {post.shape} != {out[1:]}")
        call = jax.ffi.ffi_call(TARGET,
                                jax.ShapeDtypeStruct(out, jnp.uint32))
        return call(x, tabs, pre_d, post_d, **attrs)

    return run


if __name__ == "__main__":
    print(build_library())
