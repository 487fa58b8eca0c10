"""The chunked Mamba2 SSD forward scan as CUDA C++ kernels.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``
(``_ssd_kernel``), which the JAX package reaches once per Mamba2 layer
per forward through ``models/mamba2.py::ssd_chunked_pallas``. The port's
``models/mamba2.py`` calls this wrapper on the same route, so one
forward of mamba2-130m calls it 24 times. ``csrc/ssd_scan.cu`` gives
the design and the bound (3xTF32 tensor-core operations, 30 us at the LM
path's shape): one call is three launches on the stream, the SSD
decomposition that runs every chunk at once,

1. ``chunk_states``: the cumsum of dA and each chunk's own state;
2. ``state_pass``: the state entering each chunk, a short recurrence;
3. ``chunk_outputs``: the in-chunk term and the carried state's, with
   C Bᵀ built once per (batch, chunk, band of rows, group of heads).

``ssd_scan`` runs all three and counts one launch a call
(``ssd_scan.launches``; ``KERNELS_PER_CALL`` device kernels). The three
phase functions run one kernel each, for tests and measurements, and
count nothing. Every function checks its operands; a CPU tensor gets the
plain version (``ref.ssd_scan`` and its phases), a CUDA tensor the
kernel or an error.

The kernel takes whole chunks only: padding a ragged sequence to whole
chunks stays in Python (``models/mamba2.py``), and anything else raises.
On the card every operand must be contiguous and 16-byte aligned (the
tiles arrive by 16-byte copies), P a multiple of 4 up to 64 and N a
multiple of 4.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, ref

SMEM_LIMIT = 232_448           # dynamic shared memory one H100 block may use
MAX_P = 64                     # head dim: the 64 columns of every product
KERNELS_PER_CALL = 3           # chunk states, state pass, chunk outputs
BAND = 64                      # chunk rows a chunk-outputs block owns
# the waves of chunk-outputs blocks over the SMs to fill (one block is
# resident on an SM at a time: its shared memory): two, so that the heavy
# bands (the most causal columns, run first) and the light ones even out;
# 1.9 lets 256 blocks on 132 SMs count
MIN_WAVES = 1.9


@functools.lru_cache(maxsize=1)
def _bind():
    """The library's entry points, typed; built at first use."""
    lib = build.load("ssd_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {"ssd_scan_launch": [p] * 7 + [i] * 7 + [p],
           "ssd_scan_states_launch": [p] * 5 + [i] * 6 + [p],
           "ssd_scan_pass_launch": [p] * 2 + [i] * 6 + [p],
           "ssd_scan_outputs_launch": [p] * 6 + [i] * 7 + [p]}
    out = {}
    for name, argtypes in fns.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        out[name] = fn
    smem = lib.ssd_scan_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_longlong
    out["smem"] = smem
    return out


def heads_per_block(B: int, H: int, nc: int, Q: int, sms: int) -> int:
    """Heads a chunk-outputs block owns on a card of ``sms`` SMs: the
    fewest groups of heads that give ``MIN_WAVES`` waves of blocks (each
    block builds C Bᵀ once for its heads, so fewer groups is less work),
    the heads spread evenly over them."""
    per_group = B * nc * -(-Q // BAND)
    groups = min(H, max(1, math.ceil(MIN_WAVES * sms / per_group)))
    return -(-H // groups)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _heads(xd):
    B, H, nc, Q, _ = xd.shape
    return heads_per_block(B, H, nc, Q, _sms(xd.device.index))


def _check(xd, dA, Bm, Cm):
    if xd.dim() != 5:
        raise ValueError(f"ssd_scan: xd must be (B, H, nc, Q, P); got "
                         f"{tuple(xd.shape)}")
    B, H, nc, Q, P = xd.shape
    if dA.shape != (B, H, nc, Q):
        raise ValueError(f"ssd_scan: dA must be {(B, H, nc, Q)} (whole "
                         f"chunks); got {tuple(dA.shape)}")
    if Bm.dim() != 4 or Bm.shape[:3] != (B, nc, Q) or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: Bm and Cm must be ({B}, {nc}, {Q}, N); "
                         f"got {tuple(Bm.shape)} and {tuple(Cm.shape)}")
    _same("ssd_scan", xd, dA=dA, Bm=Bm, Cm=Cm)


def _same(fn, xd, **others):
    for name, t in (("xd", xd), *others.items()):
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32; got {t.dtype}")
        if t.device != xd.device:
            raise ValueError(f"{fn}: {name} on {t.device}, xd on "
                             f"{xd.device}")


def _library(fn, Q, P, N, *tensors):
    """The library for a CUDA call, after the kernels' own checks."""
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn}: every operand must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{fn}: every operand must start on a 16-byte "
                         f"boundary (the kernels copy 16-byte vectors)")
    if P % 4 or P > MAX_P or N % 4:
        raise ValueError(f"{fn}: the kernel takes P a multiple of 4 up to "
                         f"{MAX_P} and N a multiple of 4; got P={P}, N={N}")
    lib = _bind()
    if lib["smem"](Q, P, N) > SMEM_LIMIT:
        raise ValueError(f"{fn}: Q={Q}, P={P}, N={N} needs "
                         f"{lib['smem'](Q, P, N)} bytes of shared memory, "
                         f"over {SMEM_LIMIT}")
    return lib


def _run(fn, xd, launch, *args):
    if not xd.numel():
        return
    err = build.launch_on(xd.device.index, launch, *args)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")


def ssd_scan(xd: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor) -> torch.Tensor:
    """xd (B, H, nc, Q, P), dA (B, H, nc, Q), Bm and Cm (B, nc, Q, N), all
    fp32 -> y (B, H, nc, Q, P) fp32, as ``ref.ssd_scan`` computes it. A
    CPU tensor gets the plain version; a CUDA tensor gets the kernels
    (``ssd_scan.launches`` counts the calls) or an error."""
    _check(xd, dA, Bm, Cm)
    if xd.device.type == "cpu":
        return ref.ssd_scan(xd, dA, Bm, Cm)
    B, H, nc, Q, P = xd.shape
    N = Bm.shape[-1]
    lib = _library("ssd_scan", Q, P, N, xd, dA, Bm, Cm)
    y = torch.empty_like(xd)
    st = xd.new_empty((B, H, nc, N, P))
    cs = torch.empty_like(dA)
    _run("ssd_scan", xd, lib["ssd_scan_launch"], xd.data_ptr(),
         dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
         st.data_ptr(), cs.data_ptr(), B, H, nc, Q, P, N, _heads(xd))
    if xd.numel():
        ssd_scan.launches += 1
    return y


def chunk_states(xd: torch.Tensor, dA: torch.Tensor,
                 Bm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 1: (st (B, H, nc, N, P), cs (B, H, nc, Q)) as
    ``ref.ssd_chunk_states`` computes them."""
    _check(xd, dA, Bm, Bm)
    if xd.device.type == "cpu":
        return ref.ssd_chunk_states(xd, dA, Bm)
    B, H, nc, Q, P = xd.shape
    N = Bm.shape[-1]
    lib = _library("chunk_states", Q, P, N, xd, dA, Bm)
    st = xd.new_empty((B, H, nc, N, P))
    cs = torch.empty_like(dA)
    _run("chunk_states", xd, lib["ssd_scan_states_launch"], xd.data_ptr(),
         dA.data_ptr(), Bm.data_ptr(), st.data_ptr(), cs.data_ptr(), B, H,
         nc, Q, P, N)
    return st, cs


def state_pass(st: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """Phase 2: the state entering each chunk, (B, H, nc, N, P), as
    ``ref.ssd_state_pass`` computes it (a new tensor; ``st`` is kept)."""
    if st.dim() != 5 or cs.shape[:3] != st.shape[:3]:
        raise ValueError(f"state_pass: st (B, H, nc, N, P) and cs (B, H, "
                         f"nc, Q); got {tuple(st.shape)} and "
                         f"{tuple(cs.shape)}")
    _same("state_pass", st, cs=cs)
    if st.device.type == "cpu":
        return ref.ssd_state_pass(st, cs)[0]
    B, H, nc, N, P = st.shape
    Q = cs.shape[-1]
    lib = _library("state_pass", Q, P, N, st, cs)
    s_in = st.clone()
    _run("state_pass", st, lib["ssd_scan_pass_launch"], s_in.data_ptr(),
         cs.data_ptr(), B, H, nc, Q, P, N)
    return s_in


def chunk_outputs(xd: torch.Tensor, cs: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor, s_in: torch.Tensor,
                  hg: int | None = None) -> torch.Tensor:
    """Phase 3: y (B, H, nc, Q, P) from the cumsum ``cs`` and the states
    entering each chunk ``s_in`` (B, H, nc, N, P), as
    ``ref.ssd_chunk_outputs`` computes it. ``hg``: heads a block owns, to
    hold and time other settings than ``heads_per_block``'s."""
    _check(xd, cs, Bm, Cm)
    B, H, nc, Q, P = xd.shape
    N = Bm.shape[-1]
    if s_in.shape != (B, H, nc, N, P):
        raise ValueError(f"chunk_outputs: s_in must be {(B, H, nc, N, P)}; "
                         f"got {tuple(s_in.shape)}")
    _same("chunk_outputs", xd, s_in=s_in)
    if xd.device.type == "cpu":
        return ref.ssd_chunk_outputs(xd, cs, Bm, Cm, s_in)
    lib = _library("chunk_outputs", Q, P, N, xd, cs, Bm, Cm, s_in)
    y = torch.empty_like(xd)
    _run("chunk_outputs", xd, lib["ssd_scan_outputs_launch"], xd.data_ptr(),
         Bm.data_ptr(), Cm.data_ptr(), s_in.data_ptr(), cs.data_ptr(),
         y.data_ptr(), B, H, nc, Q, P, N, hg or _heads(xd))
    return y


ssd_scan.launches = 0
