"""B-engine beamform-detect-integrate: the hand-written CUDA kernel
(csrc/beamform.cu) and its plain PyTorch version.

Replaces bifrost_tpu/ops/beamform_pallas.py::_beamform_fn.  Both compute,
per channel c and beam b over the frames of one call,

    p[b, c] = sum_t |sum_i w[b, i] * x[t, c, i]|**2

with no conjugation of w, in one fixed order: each beam sums its stations
in ascending order from +0.0 (br += xr*wr, br -= xi*wi, bi += xr*wi,
bi += xi*wr), detects as br*br + bi*bi, and the powers are summed over
frames in ascending order from +0.0; every product and sum is rounded on
its own.  So the kernel is bitwise equal to the plain version on every
input.  Against the JAX package's four-real-matmul formulation (another
summation order) they are bitwise equal where every partial sum is an
integer below 2**24, and otherwise agree to a tolerance.

`beamform_power` launches the kernel for a CUDA tensor and runs
`beamform_power_plain` only for a tensor on the CPU; any other device
raises.  `beamform_power.launches` counts kernel launches (and nothing
else).  `launch_geometry` is the launch's shape, decided here and read
by the tests.
"""

from __future__ import annotations

import ctypes
import re

import torch

from .. import build


def _constants():
    """csrc/beamform.cu's compiled geometry (its constexprs kRows,
    kGroup, kMaxBeams, kRowBytes, kStages), read from the source so that
    the launch and the kernel cannot disagree."""
    src = (build.CSRC / "beamform.cu").read_text()
    val = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    return tuple(int(val[k]) for k in ("kRows", "kGroup", "kMaxBeams",
                                        "kRowBytes", "kStages"))


# Rows (frame, channel) a block, beams a block, beams a launch, bytes of
# a row a chunk, chunks in the ring.
ROWS, GROUP, MAX_BEAMS, ROW_BYTES, STAGES = _constants()
SMEM_LIMIT = 232448   # shared memory a block may use on sm_90


def launch_geometry(ntime, nchan, nsp, nbeam, elt_bytes, base=0):
    """The kernel's launch for x (ntime, nchan, nsp) of `elt_bytes` a
    sample (8 for complex64, 2 for ci8) at address `base`: frames a tile
    (all of a short call's frames), channels a block, beam groups,
    blocks, dynamic shared memory in bytes (the chunk ring with each
    chunk's weights, which a tile's powers reuse, and the row offsets)
    and whether
    16-byte copies apply (x and a row's bytes 16-byte aligned)."""
    frames = max(1, min(ntime, ROWS))
    chans = ROWS // frames
    groups = -(-nbeam // GROUP)
    stations = ROW_BYTES // elt_bytes
    smem = STAGES * (ROWS * ROW_BYTES + stations * GROUP * 8) + ROWS * 8
    return {"frames": frames, "chans": chans, "groups": groups,
            "blocks": -(-nchan // chans) * groups, "smem": smem,
            "vec": base % 16 == 0 and nsp * elt_bytes % 16 == 0}


def _planes(x):
    """x complex (T, C, S) or int (re, im) storage (T, C, S, 2) -> f32
    (re, im) planes, lifted exactly."""
    if x.is_complex():
        return x.real.float(), x.imag.float()
    return x[..., 0].float(), x[..., 1].float()


def beamform_power_plain(x, w):
    """x: (ntime, nchan, nsp) complex64, or ci8 storage (ntime, nchan,
    nsp, 2) int8; w: (nbeam, nsp) complex64 -> (nbeam, nchan) f32 powers,
    in the kernel's order (module docstring)."""
    xr, xi = _planes(x)
    wr, wi = w.real.float(), w.imag.float()
    ntime, nchan, nsp = xr.shape
    nbeam = w.shape[0]
    br = torch.zeros(ntime, nchan, nbeam, dtype=torch.float32,
                     device=xr.device)
    bi = torch.zeros_like(br)
    for s in range(nsp):
        a, q = xr[:, :, s, None], xi[:, :, s, None]
        br = br + a * wr[:, s]
        br = br - q * wi[:, s]
        bi = bi + a * wi[:, s]
        bi = bi + q * wr[:, s]
    pw = br * br + bi * bi
    acc = torch.zeros(nchan, nbeam, dtype=torch.float32, device=xr.device)
    for t in range(ntime):
        acc = acc + pw[t]
    return acc.T.contiguous()


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("beamform")
        lib.beamform_power.argtypes = [ctypes.c_void_p, ctypes.c_int] + \
            [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3 + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.beamform_power.restype = ctypes.c_int
        lib.beamform_info.argtypes = [ctypes.c_int] * 2 + \
            [ctypes.POINTER(ctypes.c_int)] * 4
        lib.beamform_info.restype = ctypes.c_int
        lib.beamform_error_string.argtypes = [ctypes.c_int]
        lib.beamform_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_info(int8=False, vec=True):
    """Registers, spilled bytes per thread, dynamic shared memory per
    block and resident blocks per SM of the kernel's instantiation for
    ci8 (`int8`) or complex64 voltages and 16-byte or element copies."""
    lib = _library()
    vals = [ctypes.c_int() for _ in range(4)]
    err = lib.beamform_info(int(int8), int(vec),
                            *(ctypes.byref(v) for v in vals))
    if err:
        raise RuntimeError("beamform_info failed: " +
                           lib.beamform_error_string(err).decode())
    return dict(zip(("regs", "local_bytes", "smem", "blocks_per_sm"),
                    (v.value for v in vals)))


def beamform_power(x, w, out=None):
    """The powers of `beamform_power_plain` on `x`'s device -> (nbeam,
    nchan) f32 (into `out` when given).  On the card x must be a
    contiguous complex64 (ntime, nchan, nsp) or int8 (ntime, nchan, nsp,
    2) tensor there, w a contiguous complex64 (nbeam, nsp) one, with
    1 <= nbeam <= MAX_BEAMS and nsp >= 1."""
    if x.device.type == "cpu":
        p = beamform_power_plain(x, w)
        return p if out is None else out.copy_(p)
    if x.device.type != "cuda":
        raise ValueError(f"beamform_power: unsupported device {x.device}")
    if x.dtype == torch.complex64 and x.dim() == 3:
        x_int8 = 0
    elif x.dtype == torch.int8 and x.dim() == 4 and x.shape[-1] == 2:
        x_int8 = 1
    else:
        raise TypeError(f"beamform_power: x must be complex64 (ntime, "
                        f"nchan, nsp) or int8 (ntime, nchan, nsp, 2), got "
                        f"{x.dtype} {tuple(x.shape)}")
    ntime, nchan, nsp = x.shape[:3]
    nbeam = w.shape[0]
    if w.dtype != torch.complex64 or tuple(w.shape) != (nbeam, nsp) or \
            not 1 <= nbeam <= MAX_BEAMS or nsp < 1:
        raise ValueError(f"beamform_power: w must be complex64 (nbeam <= "
                         f"{MAX_BEAMS}, {nsp}), got {w.dtype} "
                         f"{tuple(w.shape)}")
    if out is None:
        out = torch.empty(nbeam, nchan, dtype=torch.float32, device=x.device)
    if out.dtype != torch.float32 or tuple(out.shape) != (nbeam, nchan):
        raise ValueError(f"beamform_power: out must be float32 ({nbeam}, "
                         f"{nchan})")
    for name, t in (("x", x), ("w", w), ("out", out)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"beamform_power: {name} must be contiguous on "
                             f"{x.device}")
    geo = launch_geometry(ntime, nchan, nsp, nbeam, 2 if x_int8 else 8,
                          x.data_ptr())
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.beamform_power(x.data_ptr(), x_int8, w.data_ptr(),
                             out.data_ptr(), ntime, nchan, nsp, nbeam,
                             geo["frames"], geo["chans"], int(geo["vec"]),
                             stream)
    if err:
        raise RuntimeError("beamform_power launch failed: " +
                           lib.beamform_error_string(err).decode())
    beamform_power.launches += 1
    return out


beamform_power.launches = 0
