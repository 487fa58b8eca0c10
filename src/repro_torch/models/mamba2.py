"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block: the
train/prefill forward of the JAX package's ``models/mamba2.py``.

ngroups = 1 (B and C shared across heads), as in the released models.
The chunked SSD scan runs through the hand-written kernel
(``kernels/ssd_scan.py``) in its forward: ``ssd_chunked_kernel`` is the
port of ``ssd_chunked_pallas`` and the only route ``mamba_block`` takes
(the ``ssd_pallas`` lever of ``runtime/flags.py`` is accepted and
switches nothing). Its backward differentiates the
plain ``ssd_chunked``, which computes the same math, exactly as the JAX
package's ``_ssd_pallas_bwd`` does: the JAX package has no backward
kernel. That is its design, not a fallback: the forward never takes the
plain version on a CUDA tensor.

Probe mode changes nothing here: the JAX package unrolls its
inter-chunk recurrence there, and ``ssd_chunked``'s recurrence is a
Python loop already.

On the engine's 2-D ``("clients", "model")`` route a Mamba2 block's
split leaves (``w_B``/``w_C`` on the state dim, ``conv_w`` across the
concatenated x|B|C channels, the projections) are gathered whole inside
the block that uses them (``models/transformer.py::_apply_block_tp``),
so ``mamba_block`` and ``ssd_scan`` run on every head as they are.

The one-token decode block (``mamba_decode_block``) is plain tensor
ops, as it is plain jnp in the JAX package: the conv window shifted by
one, softplus dt, the decay ``dA``, and the ``dBx`` outer product into
the fp32 state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import rms_norm, silu

#: the profiler range around the plain backward of ``ssd_chunked_kernel``
SSD_BACKWARD_RANGE = "ssd_chunked_backward"


def mamba_dims(d_model, expand, head_dim, d_state):
    d_inner = expand * d_model
    nheads = d_inner // head_dim
    conv_dim = d_inner + 2 * d_state  # conv over [x, B, C], ngroups=1
    return d_inner, nheads, conv_dim


def mamba_shapes(d_model, d_state, head_dim, expand, conv_width, dtype):
    """``{leaf: (shape, dtype)}`` of one block; ``dt_bias``, ``A_log``
    and ``D`` are fp32 whatever ``dtype`` is."""
    d_inner, nheads, conv_dim = mamba_dims(d_model, expand, head_dim, d_state)
    f32 = torch.float32
    return {
        "w_z": ((d_model, d_inner), dtype),
        "w_x": ((d_model, d_inner), dtype),
        "w_B": ((d_model, d_state), dtype),
        "w_C": ((d_model, d_state), dtype),
        "w_dt": ((d_model, nheads), dtype),
        "dt_bias": ((nheads,), f32),
        "A_log": ((nheads,), f32),
        "D": ((nheads,), f32),
        "conv_w": ((conv_width, conv_dim), dtype),
        "conv_b": ((conv_dim,), dtype),
        "gate_norm": ((d_inner,), dtype),
        "w_out": ((d_inner, d_model), dtype),
    }


def softplus(x):
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``); ``F.softplus`` would switch to the identity
    above 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xbc, conv_w, conv_b):
    """Depthwise causal conv as shifted adds (no cuDNN, so no TF32).
    xbc: (B, S, C); conv_w: (W, C)."""
    W, S = conv_w.shape[0], xbc.shape[1]
    out = xbc * conv_w[W - 1]
    for i in range(1, W):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :S]
        out = out + shifted * conv_w[W - 1 - i]
    return out + conv_b


def segsum_exp(dA_cs):
    """exp(dA_cs[i] - dA_cs[j]) masked to i >= j. dA_cs: (..., L, h).

    The mask is applied INSIDE the exp (as -1e30): masking the overflowed
    exp afterwards leaves inf * 0 in the backward pass (NaN grads)."""
    L = dA_cs.shape[-2]
    diff = dA_cs[..., :, None, :] - dA_cs[..., None, :, :]   # (..., i, j, h)
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool,
                                 device=dA_cs.device))[..., None]
    return torch.exp(torch.where(mask, diff, torch.full_like(diff, -1e30)))


def _chunk_inputs(chunk, x, dt, A, Bm, Cm):
    """The scan's inputs in fp32, padded to whole chunks and cut into
    them: xd = x * dt (b, nc, L, h, p), dA = dt * A (b, nc, L, h) <= 0,
    and B, C (b, nc, L, n)."""
    b, _, h, p = x.shape
    n = Bm.shape[-1]
    pad = (-x.shape[1]) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xd = (x * dt[..., None]).float().reshape(b, nc, chunk, h, p)
    dA = (dt * A).float().reshape(b, nc, chunk, h)
    Bc = Bm.reshape(b, nc, chunk, n).float()
    Cc = Cm.reshape(b, nc, chunk, n).float()
    return xd, dA, Bc, Cc


def ssd_chunked(x, dt, A, Bm, Cm, chunk, initial_state=None):
    """Chunked SSD scan in plain PyTorch (the oracle).

    x: (b, s, h, p) values; dt: (b, s, h) step sizes (post-softplus);
    A: (h,) negative decay rates; Bm, Cm: (b, s, n). Returns (y,
    final_state) with y (b, s, h, p) in x's dtype, state (b, h, p, n)
    fp32. A ragged s is padded to whole chunks and cut back."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    xc, dAc, Bc, Cc = _chunk_inputs(chunk, x, dt, A, Bm, Cm)
    nc = xc.shape[1]
    dA_cs = torch.cumsum(dAc, dim=2)                          # (b,nc,L,h)

    # intra-chunk (quadratic within the chunk)
    Lmat = segsum_exp(dA_cs)                                  # (b,nc,L,L,h)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)              # (b,nc,L,L)
    W = CB[..., None] * Lmat                                  # (b,nc,L,L,h)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", W, xc)

    # chunk boundary states
    decay_out = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)        # (b,nc,L,h)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", Bc, decay_out, xc)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])               # (b,nc,h)

    # inter-chunk recurrence (each chunk sees the state before it)
    state = (torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prevs, dim=1)                   # (b,nc,h,p,n)

    # state -> output within the chunk
    decay_in = torch.exp(dA_cs)                               # (b,nc,L,h)
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, prev_states, decay_in)

    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :s]
    return y.to(x.dtype), state


def _ssd_kernel_forward(chunk, x, dt, A, Bm, Cm):
    """``ssd_chunked``'s inputs laid out for the kernel's (B, H, nc)
    blocks, zero initial state; y in x's dtype."""
    b, s, h, p = x.shape
    xd, dA, Bc, Cc = _chunk_inputs(chunk, x, dt, A, Bm, Cm)
    y = kops.ssd_scan(xd.permute(0, 3, 1, 2, 4).contiguous(),
                      dA.permute(0, 3, 1, 2).contiguous(),
                      Bc.contiguous(), Cc.contiguous())       # fp32
    y = y.permute(0, 2, 3, 1, 4).reshape(b, -1, h, p)[:, :s]
    return y.to(x.dtype)


class _SSDScan(torch.autograd.Function):
    """Kernel forward, plain backward (the gradient of ``ssd_chunked``)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return _ssd_kernel_forward(chunk, x, dt, A, Bm, Cm)

    @staticmethod
    def backward(ctx, g):
        # the range lets a profile sum the device time of this backward's
        # kernels; it records nothing when no profiler runs
        with torch.profiler.record_function(SSD_BACKWARD_RANGE), \
                torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y, _ = ssd_chunked(*ins, ctx.chunk)
            grads = torch.autograd.grad(y, ins, g)
        return (*grads, None)


def ssd_chunked_kernel(x, dt, A, Bm, Cm, chunk):
    """The chunked SSD scan through the ``ssd_scan`` kernel (its plain
    version on the CPU). Forward: the kernel, which carries the state
    across chunks on chip and never forms the (S, S) matrix; backward:
    the gradient of ``ssd_chunked``. Returns y only (the train/prefill
    path discards the final state)."""
    return _SSDScan.apply(x, dt, A, Bm, Cm, chunk)


def mamba_block(params, x, *, d_state, head_dim, expand, conv_width, chunk,
                norm_eps=1e-5):
    """Full Mamba2 block forward (train/prefill). x: (B, S, d)."""
    B, S, d = x.shape
    d_inner, nheads, conv_dim = mamba_dims(d, expand, head_dim, d_state)
    z = x @ params["w_z"]
    xin = x @ params["w_x"]
    Bm = x @ params["w_B"]
    Cm = x @ params["w_C"]
    dt_raw = x @ params["w_dt"]

    xbc = torch.cat([xin, Bm, Cm], dim=-1)
    xbc = silu(_causal_conv(xbc, params["conv_w"], params["conv_b"]))
    xin, Bm, Cm = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)

    dt = softplus(dt_raw.float() + params["dt_bias"])         # fp32
    A = -torch.exp(params["A_log"])
    xh = xin.reshape(B, S, nheads, head_dim)
    y = ssd_chunked_kernel(xh, dt, A, Bm, Cm, chunk)          # xh's dtype
    y = y + xh * params["D"][None, None, :, None].to(xh.dtype)
    y = y.reshape(B, S, d_inner)
    y = rms_norm(y * silu(z), params["gate_norm"], norm_eps)
    return y @ params["w_out"]


def mamba_decode_block(params, x, conv_state, ssm_state, *, d_state,
                       head_dim, expand, conv_width, norm_eps=1e-5):
    """One-token decode. x: (B, 1, d); conv_state: (B, W-1, conv_dim) in
    the model dtype; ssm_state: (B, h, p, n) fp32. Returns (y, the new
    conv state, the new ssm state): new tensors, which the caller writes
    into its cache."""
    B, _, d = x.shape
    d_inner, nheads, conv_dim = mamba_dims(d, expand, head_dim, d_state)
    z = x @ params["w_z"]
    xin = x @ params["w_x"]
    Bm = x @ params["w_B"]
    Cm = x @ params["w_C"]
    dt_raw = x @ params["w_dt"]

    xbc = torch.cat([xin, Bm, Cm], dim=-1)                    # (B,1,conv_dim)
    window = torch.cat([conv_state, xbc], dim=1)              # (B,W,conv_dim)
    new_conv_state = window[:, 1:]
    conv_out = (window * params["conv_w"][None]).sum(dim=1, keepdim=True)
    xbc = silu(conv_out + params["conv_b"])
    xin, Bm, Cm = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)

    dt = softplus(dt_raw.float() + params["dt_bias"])         # (B,1,h)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt[:, 0] * A)                              # (B,h)
    xh = xin.reshape(B, nheads, head_dim).float()
    # dt B first, then x, the order the JAX package's einsum contracts in
    dtB = dt[:, 0, :, None] * Bm[:, 0].float()[:, None, :]    # (B,h,n)
    dBx = xh[..., None] * dtB[:, :, None, :]                  # (B,h,p,n)
    new_ssm_state = ssm_state * dA[:, :, None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), new_ssm_state)
    y = y + xh * params["D"][None, :, None]
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = rms_norm(y * silu(z), params["gate_norm"], norm_eps)
    return y @ params["w_out"], new_conv_state, new_ssm_state
