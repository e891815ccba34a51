"""Runtime compilation of user CUDA kernels: ``CudaModule`` over NVRTC.

Port of ``incubator_mxnet_tpu/rtc.py`` (TPU kernel B6: ``Kernel.launch``,
``rtc.py:36``, reaching ``pl.pallas_call`` at ``:54``, behind
``PallasModule``, ``:63``).  The JAX package stood Pallas in for the
reference's NVRTC ``CudaModule`` (include/mxnet/rtc.h:39,
python/mxnet/rtc.py); on the card the reference's own design is the
port: user CUDA C source, compiled at run time, launched on NDArrays.

* ``CudaModule(source, options=(), exports=())`` compiles the source
  with NVRTC when it is constructed, for the real architecture of the
  current device (``--gpu-architecture=sm_90a`` on an H100) into a
  CUBIN: PTX would need a driver at least as new as NVRTC.  A compile
  error raises ``MXNetError`` carrying NVRTC's log.  ``extern "C"``
  kernels are found by their plain name; C++ and template kernels are
  named in ``exports`` (e.g. ``"scale_add<float>"``) and looked up by
  their lowered names.
* ``get_kernel(name, signature)`` parses a C parameter list such as
  ``"const float *x, float *y, float alpha, int n"`` over the
  reference's type table and resolves the kernel; an unknown kernel or
  type raises ``MXNetError``.
* ``Kernel.launch(args, ctx, grid_dims, block_dims, shared_mem=0)``
  checks each argument (a pointer takes a contiguous NDArray of the
  declared dtype on ``ctx``; a scalar a Python number, passed with its
  exact C type) and launches on torch's current stream of that device,
  with no synchronisation: the kernel writes into the NDArrays passed
  to it, in place.  A non-GPU ``ctx`` raises, as in the reference.
  Dynamic shared memory above 48 KB is allowed first with
  ``cuFuncSetAttribute``.  Every driver call's return code is checked:
  a refused launch never runs, and a later synchronise does not report
  it.
* ``Kernel.launches`` and the module's ``launches`` count launches.

Binding is ctypes only, with no build step: ``libnvrtc`` (found by
``_build.nvrtc_path``) and the driver's ``libcuda.so.1`` for
``cuModuleLoadData``, ``cuModuleGetFunction``, ``cuFuncSetAttribute``
and ``cuLaunchKernel``.  The driver API needs a current context; torch
makes the device's primary context current only on threads that used
CUDA, so a launch makes it current itself when the thread has none
(and pushes it around the call when another device's is current).  One
``CUmodule`` is loaded per (device, module).  Without the libraries or
a CUDA device, construction raises a named ``MXNetError``; there is no
other path.  rtc has no plain version of its own, since it compiles
arbitrary source: the plain versions belong to the user kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import re
import threading

import numpy as np
import torch

from . import _build
from .base import MXNetError
from .context import Context
from .ndarray import NDArray

__all__ = ["CudaModule", "Kernel", "CudaKernel", "launches"]

# launches of every rtc kernel, for the main-path checks
launches = 0

# the reference's type table (python/mxnet/rtc.py _DTYPE_CPP_TO_NP)
_TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, ctypes.c_uint16),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int8_t": (torch.int8, ctypes.c_int8),
    "char": (torch.int8, ctypes.c_int8),
    "int64_t": (torch.int64, ctypes.c_int64),
}
_INT_BITS = {torch.uint8: (0, 255), torch.int8: (-2 ** 7, 2 ** 7 - 1),
             torch.int32: (-2 ** 31, 2 ** 31 - 1),
             torch.int64: (-2 ** 63, 2 ** 63 - 1)}
_PARAM_RE = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")
_MAX_STATIC_SHARED = 48 * 1024
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8


class _Param:
    """One kernel parameter: (const, C type, pointer, name)."""

    __slots__ = ("const", "ctype", "pointer", "name", "dtype", "c_type")

    def __init__(self, const, ctype, pointer, name):
        self.const, self.ctype, self.pointer, self.name = (const, ctype,
                                                           pointer, name)
        self.dtype, self.c_type = _TYPES[ctype]

    def __repr__(self):
        return (f"{'const ' if self.const else ''}{self.ctype}"
                f"{' *' if self.pointer else ' '}{self.name or ''}")

    def value(self, arg, device, index):
        """The ctypes value of argument ``index`` for this parameter."""
        what = f"argument {index} ({self!r})"
        if self.pointer:
            if not isinstance(arg, NDArray):
                raise MXNetError(f"{what} takes an NDArray, not "
                                 f"{type(arg).__name__}")
            t = arg._data
            if t.device != device:
                raise MXNetError(f"{what} is on {t.device}, the launch "
                                 f"on {device}")
            if t.dtype != self.dtype:
                raise MXNetError(f"{what} takes {self.dtype}, not "
                                 f"{t.dtype}")
            if not t.is_contiguous():
                raise MXNetError(f"{what} must be contiguous")
            return ctypes.c_void_p(t.data_ptr())
        if isinstance(arg, (NDArray, bool)) or not isinstance(
                arg, (int, float, np.integer, np.floating)):
            raise MXNetError(f"{what} takes a Python number, not "
                             f"{type(arg).__name__}")
        if self.dtype.is_floating_point:
            if self.dtype == torch.float16:
                return self.c_type(int(np.float16(arg).view(np.uint16)))
            return self.c_type(float(arg))
        if not isinstance(arg, (int, np.integer)):
            raise MXNetError(f"{what} takes an integer, not {arg!r}")
        lo, hi = _INT_BITS[self.dtype]
        if not lo <= int(arg) <= hi:
            raise MXNetError(f"{what}: {arg} is out of range for "
                             f"{self.ctype}")
        return self.c_type(int(arg))


def _parse_signature(signature):
    """A C parameter list -> [_Param] (reference rtc.py:get_kernel)."""
    text = re.sub(r"\s+", " ", signature).strip()
    if text in ("", "void"):
        return []
    params = []
    for arg in text.split(","):
        m = _PARAM_RE.match(arg)
        if not m or m.group(2) == "const":
            raise MXNetError(f'invalid kernel parameter "{arg.strip()}": '
                             'must be of the form "(const) type (*) (name)"')
        if m.group(2) not in _TYPES:
            raise MXNetError(f'unsupported kernel parameter type '
                             f'"{m.group(2)}" (supported: '
                             f'{", ".join(_TYPES)})')
        params.append(_Param(bool(m.group(1)), m.group(2),
                             bool(m.group(3)), m.group(4)))
    return params


# ------------------------------------------------------------------ bindings
class _NVRTC:
    """ctypes binding of libnvrtc."""

    def __init__(self, path):
        lib = self.lib = ctypes.CDLL(path)
        p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        pp = ctypes.POINTER(ctypes.c_char_p)
        for name, args in (
                ("nvrtcCreateProgram", [ctypes.POINTER(p), ctypes.c_char_p,
                                        ctypes.c_char_p, i, pp, pp]),
                ("nvrtcDestroyProgram", [ctypes.POINTER(p)]),
                ("nvrtcAddNameExpression", [p, ctypes.c_char_p]),
                ("nvrtcCompileProgram", [p, i, pp]),
                ("nvrtcGetProgramLogSize", [p, ctypes.POINTER(sz)]),
                ("nvrtcGetProgramLog", [p, ctypes.c_char_p]),
                ("nvrtcGetCUBINSize", [p, ctypes.POINTER(sz)]),
                ("nvrtcGetCUBIN", [p, ctypes.c_char_p]),
                ("nvrtcGetLoweredName", [p, ctypes.c_char_p, pp])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
        lib.nvrtcGetErrorString.argtypes = [i]
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p

    def check(self, rc, what):
        if rc:
            msg = self.lib.nvrtcGetErrorString(rc).decode()
            raise MXNetError(f"{what} failed: {msg} ({rc})")


class _Driver:
    """ctypes binding of the CUDA driver API (libcuda.so.1)."""

    def __init__(self):
        try:
            lib = self.lib = ctypes.CDLL("libcuda.so.1")
        except OSError as e:
            raise MXNetError(f"the CUDA driver (libcuda.so.1) cannot be "
                             f"loaded: {e}") from e
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        pp = ctypes.POINTER(p)
        for name, args in (
                ("cuInit", [u]),
                ("cuDeviceGet", [ctypes.POINTER(i), i]),
                ("cuDevicePrimaryCtxRetain", [pp, i]),
                ("cuCtxGetCurrent", [pp]),
                ("cuCtxSetCurrent", [p]),
                ("cuCtxPushCurrent_v2", [p]),
                ("cuCtxPopCurrent_v2", [pp]),
                ("cuModuleLoadData", [pp, p]),
                ("cuModuleGetFunction", [pp, p, ctypes.c_char_p]),
                ("cuFuncSetAttribute", [p, i, i]),
                ("cuLaunchKernel", [p, u, u, u, u, u, u, u, p, pp, pp])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
        for name in ("cuGetErrorName", "cuGetErrorString"):
            fn = getattr(lib, name)
            fn.argtypes = [i, ctypes.POINTER(ctypes.c_char_p)]
            fn.restype = i
        self._primary = {}
        self.check(lib.cuInit(0), "cuInit")

    def check(self, rc, what):
        if rc:
            name, text = ctypes.c_char_p(), ctypes.c_char_p()
            self.lib.cuGetErrorName(rc, ctypes.byref(name))
            self.lib.cuGetErrorString(rc, ctypes.byref(text))
            raise MXNetError(
                f"{what} failed: {(name.value or b'?').decode()}: "
                f"{(text.value or b'unknown error').decode()} ({rc})")

    def primary(self, index):
        """The primary context of device ``index``, retained once."""
        ctx = self._primary.get(index)
        if ctx is None:
            dev = ctypes.c_int()
            self.check(self.lib.cuDeviceGet(ctypes.byref(dev), index),
                       "cuDeviceGet")
            ctx = ctypes.c_void_p()
            self.check(self.lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                         dev),
                       "cuDevicePrimaryCtxRetain")
            self._primary[index] = ctx
        return ctx

    @contextlib.contextmanager
    def current(self, index):
        """Device ``index``'s primary context current on this thread for
        the block: set when the thread has none, pushed and popped when
        another context is current."""
        primary = self.primary(index)
        cur = ctypes.c_void_p()
        self.check(self.lib.cuCtxGetCurrent(ctypes.byref(cur)),
                   "cuCtxGetCurrent")
        if cur.value == primary.value:
            yield
        elif not cur.value:
            self.check(self.lib.cuCtxSetCurrent(primary), "cuCtxSetCurrent")
            yield
        else:
            self.check(self.lib.cuCtxPushCurrent_v2(primary),
                       "cuCtxPushCurrent")
            try:
                yield
            finally:
                popped = ctypes.c_void_p()
                self.check(self.lib.cuCtxPopCurrent_v2(ctypes.byref(popped)),
                           "cuCtxPopCurrent")


_bind_lock = threading.Lock()
_bound = {}


def _bindings():
    """(NVRTC, driver), loaded at first use.  Raises MXNetError without
    libnvrtc, without the driver or without a CUDA device."""
    with _bind_lock:
        if not _bound:
            nvrtc = _NVRTC(_build.nvrtc_path())
            if not torch.cuda.is_available():
                raise MXNetError("rtc.CudaModule needs a CUDA device: none "
                                 "is available")
            torch.cuda.init()
            _bound["nvrtc"], _bound["driver"] = nvrtc, _Driver()
        return _bound["nvrtc"], _bound["driver"]


def _arch(index):
    """NVRTC's real architecture for device ``index`` (sm_90a on Hopper,
    whose wgmma / setmaxnreg exist only for the 'a' target)."""
    major, minor = torch.cuda.get_device_capability(index)
    return f"sm_{major}{minor}" + ("a" if (major, minor) == (9, 0) else "")


# ------------------------------------------------------------------ module
class CudaModule:
    """CUDA C source compiled at run time with NVRTC (reference
    python/mxnet/rtc.py:CudaModule(source, options, exports))."""

    def __init__(self, source, options=(), exports=()):
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        self._nvrtc, self._driver = _bindings()
        self._lock = threading.Lock()
        self._images = {}       # arch -> (cubin, {export: lowered name})
        self._modules = {}      # device index -> CUmodule
        self._functions = {}    # (device index, name) -> CUfunction
        self._shared = {}       # CUfunction value -> dynamic bytes allowed
        self._image(_arch(torch.cuda.current_device()))

    def _image(self, arch):
        if arch not in self._images:
            self._images[arch] = self._compile(arch)
        return self._images[arch]

    def _compile(self, arch):
        nv = self._nvrtc
        opts = list(self.options)
        if not any(o.startswith(("-arch", "--gpu-architecture"))
                   for o in opts):
            opts.insert(0, f"--gpu-architecture={arch}")
        opts += [f"-I{d}" for d in _build.cuda_include_dirs()]
        prog = ctypes.c_void_p()
        nv.check(nv.lib.nvrtcCreateProgram(
            ctypes.byref(prog), self.source.encode(), b"rtc_module.cu", 0,
            None, None), "nvrtcCreateProgram")
        try:
            for e in self.exports:
                nv.check(nv.lib.nvrtcAddNameExpression(prog, e.encode()),
                         f"nvrtcAddNameExpression({e!r})")
            copts = (ctypes.c_char_p * len(opts))(*[o.encode()
                                                    for o in opts])
            rc = nv.lib.nvrtcCompileProgram(prog, len(opts), copts)
            size = ctypes.c_size_t()
            nv.check(nv.lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)),
                     "nvrtcGetProgramLogSize")
            log = ctypes.create_string_buffer(size.value)
            nv.check(nv.lib.nvrtcGetProgramLog(prog, log),
                     "nvrtcGetProgramLog")
            if rc:
                msg = nv.lib.nvrtcGetErrorString(rc).decode()
                raise MXNetError(
                    f"NVRTC compile failed ({msg}) with options {opts}:\n"
                    f"{log.value.decode(errors='replace')}")
            nv.check(nv.lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
            cubin = ctypes.create_string_buffer(size.value)
            nv.check(nv.lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
            lowered = {}
            for e in self.exports:
                name = ctypes.c_char_p()
                nv.check(nv.lib.nvrtcGetLoweredName(prog, e.encode(),
                                                    ctypes.byref(name)),
                         f"nvrtcGetLoweredName({e!r})")
                lowered[e] = name.value.decode()
        finally:
            nv.lib.nvrtcDestroyProgram(ctypes.byref(prog))
        return cubin.raw, lowered

    def _function(self, name, index):
        """The CUfunction of kernel ``name`` on device ``index``, its
        module loaded there at first use.  The caller holds the
        device's context current."""
        key = (index, name)
        with self._lock:
            func = self._functions.get(key)
            if func is not None:
                return func
            cubin, lowered = self._image(_arch(index))
            drv = self._driver
            module = self._modules.get(index)
            if module is None:
                module = ctypes.c_void_p()
                drv.check(drv.lib.cuModuleLoadData(ctypes.byref(module),
                                                   cubin),
                          "cuModuleLoadData")
                self._modules[index] = module
            func = ctypes.c_void_p()
            rc = drv.lib.cuModuleGetFunction(
                ctypes.byref(func), module, lowered.get(name, name).encode())
            if rc:
                raise MXNetError(
                    f"kernel {name!r} not found in the module (exports: "
                    f"{list(self.exports)}): an extern \"C\" kernel is "
                    "found by its name, a C++ or template kernel through "
                    "exports")
            self._functions[key] = func
            return func

    def _allow_shared(self, func, nbytes):
        """Allow ``nbytes`` of dynamic shared memory for ``func``, once
        per size above what it has."""
        with self._lock:
            if self._shared.get(func.value, _MAX_STATIC_SHARED) >= nbytes:
                return
            self._driver.check(self._driver.lib.cuFuncSetAttribute(
                func, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                nbytes), "cuFuncSetAttribute(MAX_DYNAMIC_SHARED_SIZE_BYTES)")
            self._shared[func.value] = nbytes

    def get_kernel(self, name, signature):
        """The kernel ``name`` (an ``extern "C"`` name or an export) with
        the C parameter list ``signature`` (reference
        rtc.py:CudaModule.get_kernel)."""
        params = _parse_signature(signature)
        index = torch.cuda.current_device()
        with self._driver.current(index):
            self._function(name, index)
        return Kernel(self, name, params)


class Kernel:
    """One launchable kernel of a ``CudaModule`` (reference
    rtc.py:CudaKernel)."""

    def __init__(self, module, name, params):
        self._module = module
        self._name = name
        self._params = params
        self.launches = 0

    @property
    def signature(self):
        return ", ".join(map(repr, self._params))

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (a GPU context) over ``grid_dims`` x
        ``block_dims`` (1 to 3 ints each) with ``shared_mem`` bytes of
        dynamic shared memory, on torch's current stream of that device.
        Asynchronous; writes into the NDArrays passed, in place."""
        global launches
        ctx = Context(ctx)
        if ctx.device_type in ("cpu", "cpu_pinned"):
            raise MXNetError(f"rtc kernels launch on a GPU context, not "
                             f"{ctx}")
        if len(args) != len(self._params):
            raise MXNetError(f"kernel {self._name} takes "
                             f"{len(self._params)} arguments "
                             f"({self.signature}), got {len(args)}")
        device = ctx.torch_device()
        values = [p.value(a, device, i)
                  for i, (p, a) in enumerate(zip(self._params, args))]
        grid, block = _dims(grid_dims, "grid_dims"), _dims(block_dims,
                                                          "block_dims")
        shared_mem = int(shared_mem)
        if shared_mem < 0:
            raise MXNetError(f"shared_mem must be >= 0, got {shared_mem}")
        kernel_params = (ctypes.c_void_p * max(len(values), 1))(
            *[ctypes.addressof(v) for v in values])
        stream = ctypes.c_void_p(torch.cuda.current_stream(device)
                                 .cuda_stream)
        mod, drv = self._module, self._module._driver
        with drv.current(device.index):
            func = mod._function(self._name, device.index)
            if shared_mem > _MAX_STATIC_SHARED:
                mod._allow_shared(func, shared_mem)
            drv.check(drv.lib.cuLaunchKernel(func, *grid, *block, shared_mem,
                                             stream, kernel_params, None),
                      f"cuLaunchKernel({self._name})")
        self.launches += 1
        launches += 1


CudaKernel = Kernel


def _dims(dims, what):
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    if not 1 <= len(dims) <= 3 or any(
            not isinstance(d, (int, np.integer)) or d < 1 for d in dims):
        raise MXNetError(f"{what} must be 1 to 3 positive ints, got {dims}")
    return tuple(int(d) for d in dims) + (1,) * (3 - len(dims))
