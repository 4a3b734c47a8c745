"""ctypes binding of the native (C++) model compiler.

Port of ``tactilesimulation_tpu/model/native.py``: ``compile_scene(path)``
runs ``native/model_compiler.cpp`` on a redmax XML file and returns a
``NativeModel``, its counts, name lists and flat numpy arrays. The Python
parser (``xml_parser.py``) stays the reference; the tests hold the two
together.

The library is built at first use with ``g++ -O2 -shared -fPIC`` into the
package's ``build/`` (beside the CUDA libraries of ``ops/_build.py``),
again whenever the source is newer. A failed build raises with the
compiler's output; nothing falls back to the Python parser.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

import numpy as np

from ..ops._build import BUILD

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "model_compiler.cpp")
LIBRARY = os.path.join(BUILD, "libtsim_model.so")
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_LIB = None


def build_native(force: bool = False) -> str:
    """Compile ``native/model_compiler.cpp`` if ``force`` or the library is
    missing or older than the source; returns the library path. The output
    goes to a temporary file that is renamed, so a cut build leaves no half
    library."""
    if (not force and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return LIBRARY
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native model compiler is "
                           "built with the host's C++ compiler")
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIBRARY


_DOUBLE_ARRAYS = {
    "joint_pos", "joint_quat", "joint_axis0", "joint_axis1", "joint_damping",
    "joint_lim_lower", "joint_lim_upper", "joint_lim_stiffness", "body_pos",
    "body_quat", "body_size", "body_mass", "body_inertia", "cp_pos",
    "pair_params", "motor_P", "motor_D", "motor_lo", "motor_hi", "tac_pos",
    "tac_normal", "tac_axis0", "tac_axis1", "tac_params", "ee_pos",
}
_INT_ARRAYS = {
    "joint_type", "joint_parent", "body_gtype", "body_joint", "cp_body",
    "pair_general", "pair_primitive", "motor_joint", "motor_is_position",
    "tac_body", "tac_count", "tac_image_pos", "ee_joint",
}
_COUNTS = ("integrator", "has_ground", "njoints", "nbodies", "ndof",
           "npoints", "npairs", "nmotors", "nsensors", "nmarkers", "nee",
           "solver_max_iter")


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_native())
        ptr = ctypes.c_void_p
        lib.tsim_compile.restype = ptr
        lib.tsim_compile.argtypes = [ctypes.c_char_p, ctypes.c_double]
        lib.tsim_error.restype = ctypes.c_char_p
        lib.tsim_error.argtypes = [ptr]
        lib.tsim_free.argtypes = [ptr]
        for name in ("timestep", "solver_tol"):
            fn = getattr(lib, f"tsim_{name}")
            fn.restype, fn.argtypes = ctypes.c_double, [ptr]
        for name in _COUNTS:
            fn = getattr(lib, f"tsim_{name}")
            fn.restype, fn.argtypes = ctypes.c_int, [ptr]
        for name in ("gravity", "ground_pos", "ground_normal"):
            fn = getattr(lib, f"tsim_{name}")
            fn.restype, fn.argtypes = ctypes.POINTER(ctypes.c_double), [ptr]
        for name in (("joint_names", "body_names", "tac_names", "ee_names")
                     + tuple(_DOUBLE_ARRAYS | _INT_ARRAYS)):
            fn = getattr(lib, f"tsim_{name}")
            fn.restype, fn.argtypes = ptr, [ptr]
        _LIB = lib
    return _LIB


def _names(ptr, n):
    """n NUL-terminated strings laid end to end from ``ptr``."""
    out, addr = [], ptr
    for _ in range(n):
        s = ctypes.string_at(addr).decode()
        out.append(s)
        addr += len(s.encode()) + 1
    return out


class NativeModel:
    """The native compiler's output: counts, the integrator, gravity and
    ground, numpy arrays (flat, as the library lays them out) and name
    lists."""

    def __init__(self, path: str, mesh_fallback_extent: float = 0.04):
        lib = self._lib = _lib()
        self._blob = lib.tsim_compile(os.fsencode(path),
                                      ctypes.c_double(mesh_fallback_extent))
        err = lib.tsim_error(self._blob)
        if err:
            lib.tsim_free(self._blob)
            self._blob = None
            raise RuntimeError(f"native compile failed: {err.decode()}")
        g = lambda n: getattr(lib, f"tsim_{n}")(self._blob)
        self.timestep = g("timestep")
        self.integrator = "BDF2" if g("integrator") == 2 else "BDF1"
        self.has_ground = bool(g("has_ground"))
        self.solver_tol = g("solver_tol")
        self.solver_max_iter = g("solver_max_iter")
        for name in ("njoints", "nbodies", "ndof", "npoints", "npairs",
                     "nmotors", "nsensors", "nmarkers", "nee"):
            setattr(self, name, g(name))
        for name in ("gravity", "ground_pos", "ground_normal"):
            setattr(self, name, np.ctypeslib.as_array(g(name), (3,)).copy())

        J, NB, P, K = self.njoints, self.nbodies, self.npoints, self.npairs
        U, S, M, E = self.nmotors, self.nsensors, self.nmarkers, self.nee
        counts = {
            "joint_pos": 3 * J, "joint_quat": 4 * J, "joint_axis0": 3 * J,
            "joint_axis1": 3 * J, "joint_damping": J, "joint_lim_lower": J,
            "joint_lim_upper": J, "joint_lim_stiffness": J,
            "body_pos": 3 * NB, "body_quat": 4 * NB, "body_size": 3 * NB,
            "body_mass": NB, "body_inertia": 3 * NB, "cp_pos": 3 * P,
            "pair_params": 4 * K, "motor_P": U, "motor_D": U, "motor_lo": U,
            "motor_hi": U, "tac_pos": 3 * M, "tac_normal": 3 * M,
            "tac_axis0": 3 * M, "tac_axis1": 3 * M, "tac_params": 4 * S,
            "ee_pos": 3 * E, "joint_type": J, "joint_parent": J,
            "body_gtype": NB, "body_joint": NB, "cp_body": P,
            "pair_general": K, "pair_primitive": K, "motor_joint": U,
            "motor_is_position": U, "tac_body": S, "tac_count": S,
            "tac_image_pos": 2 * M, "ee_joint": E,
        }
        for name, n in counts.items():
            double = name in _DOUBLE_ARRAYS
            if n == 0:
                arr = np.zeros(0, np.float64 if double else np.int32)
            else:
                ctype = ctypes.c_double if double else ctypes.c_int
                arr = np.ctypeslib.as_array(
                    ctypes.cast(g(name), ctypes.POINTER(ctype)), (n,)).copy()
            setattr(self, name, arr)
        self.joint_names = _names(g("joint_names"), J)
        self.body_names = _names(g("body_names"), NB)
        self.tac_names = _names(g("tac_names"), S)
        self.ee_names = _names(g("ee_names"), E)

    def __del__(self):
        if getattr(self, "_blob", None):
            self._lib.tsim_free(self._blob)


def compile_scene(path: str, mesh_fallback_extent: float = 0.04
                  ) -> NativeModel:
    return NativeModel(path, mesh_fallback_extent)
