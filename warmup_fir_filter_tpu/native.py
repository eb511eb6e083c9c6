"""ctypes bindings to the native C++ tools library (``tools/``).

The native layer is the host-side performance/verification complement of
the device paths (SURVEY.md §2.2): a streaming Direct-Form-I FIR, a
bit-exact fixed-point golden oracle, a radix-2 FFT over the completed
complex/twiddle library, and a golden-vector bit-compare.

Build with::

    cmake --preset release && cmake --build --preset release

The loader searches ``build/{release,debug,sanitize}`` under the repo
root; :func:`load_native` raises a clear error when the library is not
built (callers and tests gate on :func:`native_available`).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from warmup_fir_filter_tpu.ops.qformat import QFormat

_REPO_ROOT = Path(__file__).resolve().parent.parent
_LIB_CANDIDATES = [
    _REPO_ROOT / "build" / cfg / "tools" / "libwft_tools.so"
    for cfg in ("release", "debug", "sanitize")
]

_lib: ctypes.CDLL | None = None


def _find_library() -> Path | None:
    for path in _LIB_CANDIDATES:
        if path.exists():
            return path
    return None


def native_available() -> bool:
    return _find_library() is not None


def load_native() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = _find_library()
    if path is None:
        raise RuntimeError(
            "Native tools library not built. Run: "
            "cmake --preset release && cmake --build --preset release"
        )
    lib = ctypes.CDLL(str(path))

    i64 = ctypes.c_int64
    lib.wft_fir1d_fixed_rows.restype = ctypes.c_int
    lib.wft_fir1d_fixed_rows.argtypes = [
        ctypes.c_void_p, i64, i64, ctypes.c_void_p, i64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.wft_stream_create.restype = ctypes.c_void_p
    lib.wft_stream_create.argtypes = [ctypes.c_void_p, i64]
    lib.wft_stream_destroy.argtypes = [ctypes.c_void_p]
    lib.wft_stream_reset.argtypes = [ctypes.c_void_p]
    lib.wft_stream_process.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64, ctypes.c_void_p
    ]
    lib.wft_bit_compare_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64,
        ctypes.POINTER(i64), ctypes.POINTER(i64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.wft_fft_radix2.restype = ctypes.c_int
    lib.wft_fft_radix2.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64, ctypes.c_int
    ]
    _lib = lib
    return lib


def fir1d_fixed_rows_native(
    x_u8: np.ndarray, h, qformat: QFormat = QFormat()
) -> np.ndarray:
    """Bit-exact fixed FIR via the native oracle (same golden contract)."""
    lib = load_native()
    x = np.ascontiguousarray(x_u8, dtype=np.uint8)
    taps = np.ascontiguousarray(
        qformat.quantize_coeffs(h).astype(np.int64)
    )
    out = np.empty_like(x)
    rc = lib.wft_fir1d_fixed_rows(
        x.ctypes.data, x.shape[0], x.shape[1],
        taps.ctypes.data, taps.size,
        qformat.coeff_bits, qformat.frac_bits, qformat.acc_bits,
        out.ctypes.data,
    )
    if rc != 0:
        raise ValueError("wft_fir1d_fixed_rows rejected its arguments")
    return out


class NativeFirStream:
    """Sample-streaming float FIR backed by the C++ delay-line model."""

    def __init__(self, taps):
        self._lib = load_native()
        taps64 = np.ascontiguousarray(taps, dtype=np.float64)
        self._handle = self._lib.wft_stream_create(
            taps64.ctypes.data, taps64.size
        )
        if not self._handle:
            raise ValueError("invalid taps for native stream")

    def process(self, x) -> np.ndarray:
        x64 = np.ascontiguousarray(x, dtype=np.float64)
        out = np.empty_like(x64)
        self._lib.wft_stream_process(
            self._handle, x64.ctypes.data, x64.size, out.ctypes.data
        )
        return out

    def reset(self) -> None:
        self._lib.wft_stream_reset(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.wft_stream_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover — best-effort cleanup
        try:
            self.close()
        except Exception:
            pass


def bit_compare_u8(a: np.ndarray, b: np.ndarray) -> dict:
    """Golden-vector bit-compare via the native tool."""
    lib = load_native()
    a8 = np.ascontiguousarray(a, dtype=np.uint8).reshape(-1)
    b8 = np.ascontiguousarray(b, dtype=np.uint8).reshape(-1)
    if a8.size != b8.size:
        raise ValueError(f"Size mismatch: {a8.size} vs {b8.size}")
    mism = ctypes.c_int64()
    max_err = ctypes.c_int64()
    mae = ctypes.c_double()
    rmse = ctypes.c_double()
    lib.wft_bit_compare_u8(
        a8.ctypes.data, b8.ctypes.data, a8.size,
        ctypes.byref(mism), ctypes.byref(max_err),
        ctypes.byref(mae), ctypes.byref(rmse),
    )
    return {
        "num_samples": int(a8.size),
        "num_mismatches": int(mism.value),
        "max_abs_err": int(max_err.value),
        "mae": float(mae.value),
        "rmse": float(rmse.value),
        "bit_exact": mism.value == 0,
    }


def fft_radix2_native(re: np.ndarray, im: np.ndarray,
                      inverse: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Radix-2 FFT via the native complex/twiddle library."""
    lib = load_native()
    re64 = np.ascontiguousarray(re, dtype=np.float64).copy()
    im64 = np.ascontiguousarray(im, dtype=np.float64).copy()
    rc = lib.wft_fft_radix2(
        re64.ctypes.data, im64.ctypes.data, re64.size, int(inverse)
    )
    if rc != 0:
        raise ValueError("fft size must be a power of two")
    return re64, im64
