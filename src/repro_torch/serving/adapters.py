"""Per-request adaptation routines behind the AdaptationServer.

An adapter works on all B slots at once: every tensor of a slot state
has the slot axis first. The server shares admission, masking and
retirement; the adapter supplies

- ``pack_phi(phi)``: the meta-init in the form the steps consume;
- ``prepare(pack, sx, sy)``: n requests' support sets -> n fresh slot
  rows (params initialised from phi + the prepared support);
- ``unit_step(pack, slots, step)``: ONE adaptation step of every slot
  at its cursor ``step`` (B,) -> (new slots, per-slot step loss);
- ``query_loss(pack, slots, qx, qy)``: per-slot score on the query set;
- ``finish(pack, slots)``: per-slot fp32 params handed back.

The fp32 route's step goes through the ``online_sgd`` kernel and the
int8 route's through ``dfa_epoch_int8``, each one launch for all slots.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core.strategies import (TIFED_ACT, TIFED_EX, TIFED_SERR,
                                         _tifed_constants)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.paper_nets import relu_mlp_loss


@dataclasses.dataclass(frozen=True)
class Fp32Adapter:
    """TinyReptile deployment loop: one SGD step per streamed support
    sample (the JAX package's ``core.meta.finetune_online`` update).

    A slot's parameters are one row of a flat ``(B, P)`` fp32 buffer
    (leaves in sorted-name order, viewed per leaf), so the gradient of
    the summed per-slot losses with respect to that buffer is every
    slot's own gradient, and one ``online_sgd`` launch updates all
    slots and all leaves. ``loss_fn(params, batch)`` returns one loss
    per slot."""
    loss_fn: Callable
    lr: float = 0.01

    name = "fp32"

    def pack_phi(self, phi):
        names = tuple(sorted(phi))
        shapes = tuple(tuple(phi[k].shape) for k in names)
        flat = torch.cat([phi[k].reshape(-1).float() for k in names])
        return {"names": names, "shapes": shapes, "flat": flat}

    @staticmethod
    def _views(pack, flat):
        out, off = {}, 0
        for k, shape in zip(pack["names"], pack["shapes"]):
            n = math.prod(shape)
            out[k] = flat[:, off:off + n].unflatten(1, shape)
            off += n
        return out

    def prepare(self, pack, sx, sy):
        flat = pack["flat"].expand(sx.shape[0], -1).clone()
        return {"flat": flat, "sx": sx, "sy": sy}

    def unit_step(self, pack, slots, step):
        sx, sy = slots["sx"], slots["sy"]
        rows = torch.arange(sx.shape[0], device=sx.device)
        i = step.clamp(0, sx.shape[1] - 1)
        batch = {"x": sx[rows, i].unsqueeze(1), "y": sy[rows, i].unsqueeze(1)}
        with torch.enable_grad():
            flat = slots["flat"].detach().requires_grad_(True)
            loss = self.loss_fn(self._views(pack, flat), batch)
            (g,) = torch.autograd.grad(loss.sum(), flat)
        new = kops.online_sgd(slots["flat"], g, self.lr)
        return {**slots, "flat": new}, loss.detach()

    def query_loss(self, pack, slots, qx, qy):
        return self.loss_fn(self._views(pack, slots["flat"]),
                            {"x": qx, "y": qy})

    def finish(self, pack, slots):
        return self._views(pack, slots["flat"])


@dataclasses.dataclass(frozen=True)
class TifedAdapter:
    """TIFeD int8 deployment loop: one adaptation step is one integer DFA
    epoch over the request's whole support set (layer-cyclic: epoch e
    trains layer e % 3). phi must sit on the TIFeD integer grid
    (``tifed_requantize`` output, or a TIFeD run's params).

    Slots carry native int8 weights and int32 biases. ``support`` and
    ``k_max`` are fixed per adapter: 1/support folds into the bit-shift
    learning rate and the dither planes are drawn for epochs < k_max."""
    support: int
    k_max: int
    lr_shift: int = 6
    feedback_seed: int = 0

    name = "tifed"

    def pack_phi(self, phi):
        for i in range(3):
            if f"w{i}" not in phi or f"b{i}" not in phi:
                raise ValueError(
                    "TifedAdapter expects the paper MLP tree "
                    f"{{w0,b0,w1,b1,w2,b2}}; got keys {sorted(phi)}")
        dev = phi["w0"].device
        ws, ew = [], []
        for i in range(3):
            q, e = kref.quantize_pow2(phi[f"w{i}"].float())
            ws.append(q.to(torch.int8))
            ew.append(int(e))
        ea = (TIFED_EX, TIFED_ACT, TIFED_ACT)
        sacc = [ew[i] + ea[i] for i in range(3)]
        bs = [torch.clamp(torch.round(phi[f"b{i}"].float() * 2.0 ** -sacc[i]),
                          -kref.BIAS_MAX, kref.BIAS_MAX).to(torch.int32)
              for i in range(3)]
        lrs = self.lr_shift + int(np.floor(np.log2(self.support)))

        def p2(k):                  # an exact fp32 power of two
            return np.exp2(np.float32(k))

        scales = {
            "f0": p2(sacc[0] - TIFED_ACT), "f1": p2(sacc[1] - TIFED_ACT),
            "fe": p2(sacc[2] - TIFED_SERR),
            "floss": p2(2 * sacc[2]) / np.float32(self.support),
            "ftw": tuple(p2(ea[i] + TIFED_SERR - ew[i] - lrs)
                         for i in range(3)),
            "ftb": tuple(p2(TIFED_SERR - sacc[i] - lrs) for i in range(3)),
        }
        dims = (ws[0].shape[0], ws[0].shape[1], ws[1].shape[1],
                ws[2].shape[1])
        fb_np, dith_np = _tifed_constants(self.feedback_seed, self.k_max,
                                          dims)
        return {"ws": tuple(ws), "bs": tuple(bs), "ew": tuple(ew),
                "sacc": tuple(sacc),
                "scales": kref.pack_scales(scales, device=dev),
                "fb": tuple(torch.tensor(f, device=dev).to(torch.int8)
                            for f in fb_np),
                "dith": tuple(torch.tensor(d, device=dev) for d in dith_np)}

    def prepare(self, pack, sx, sy):
        n = sx.shape[0]
        din = pack["ws"][0].shape[0]
        dout = pack["ws"][2].shape[1]
        x = sx.reshape(n, -1, din)
        y = sy.reshape(n, x.shape[1], dout)
        xq = torch.clamp(torch.round(x * 2.0 ** -TIFED_EX), -127.0, 127.0)
        yal = torch.round(y * 2.0 ** -pack["sacc"][2])
        slot = {"xq": xq.to(torch.int8), "yal": yal.to(torch.int32)}
        for i in range(3):
            for kind, src in (("w", pack["ws"]), ("b", pack["bs"])):
                t = src[i]
                slot[f"{kind}{i}"] = t.expand((n,) + t.shape).clone()
        return slot

    def unit_step(self, pack, slots, step):
        e = step.clamp(0, self.k_max - 1)
        layer = (e % 3).to(torch.int32)
        dither = tuple(d[e] for d in pack["dith"])
        ws = tuple(slots[f"w{i}"] for i in range(3))
        bs = tuple(slots[f"b{i}"] for i in range(3))
        nw, nb, loss = kops.dfa_epoch_int8(ws, bs, slots["xq"], slots["yal"],
                                           layer, pack["fb"], dither,
                                           pack["scales"])
        new = dict(slots)
        for i in range(3):
            new[f"w{i}"], new[f"b{i}"] = nw[i], nb[i]
        return new, loss

    def _dequantize(self, pack, slots):
        out = {}
        for i in range(3):
            out[f"w{i}"] = slots[f"w{i}"].float() * 2.0 ** pack["ew"][i]
            out[f"b{i}"] = slots[f"b{i}"].float() * 2.0 ** pack["sacc"][i]
        return out

    def query_loss(self, pack, slots, qx, qy):
        """fp32 ReLU-MLP MSE on the dequantized adapted params: the
        network the integer arithmetic computes."""
        return relu_mlp_loss(self._dequantize(pack, slots),
                             {"x": qx, "y": qy})

    def finish(self, pack, slots):
        return self._dequantize(pack, slots)
